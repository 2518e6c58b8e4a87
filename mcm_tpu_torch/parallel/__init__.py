from mcm_tpu_torch.parallel.eval_step import EvalStep  # noqa: F401
