from mcm_tpu_torch.parallel.eval_step import EvalStep, VitLinearStep  # noqa: F401
