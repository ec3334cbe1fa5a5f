"""PyTorch + CUDA port of the 2D NDT SLAM engine.

The JAX package ``ndt_2d_tpu`` is the reference; this package mirrors its
layout module for module and never imports ``jax``.  Plain tensor code is
PyTorch; the device hot loops (NDT build, candidate scoring, point scoring,
occupancy ray-march) are hand-written CUDA kernels under ``csrc/``, each
with a plain-PyTorch twin that runs when the tensors lie on the CPU.
"""
