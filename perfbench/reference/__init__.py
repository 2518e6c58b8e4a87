"""The plain reference that decides ``correct``: JPEG bytes to pixels by
PIL, both CLIP towers and the MCM score in plain PyTorch, float32 with TF32
off.  It imports nothing of the program (``mcm_tpu_torch``), nor ``jax`` or
the JAX package, and takes nothing the program made: it gets the JPEG
files, the weight arrays and the token ids that the benchmark made, and
works the pixels, features and scores out again.
"""
