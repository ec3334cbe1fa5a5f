"""Hand-written CUDA kernels, each beside its plain-PyTorch twin.

Every wrapper dispatches on its inputs' device: CPU tensors run the twin,
CUDA tensors launch the kernel (or raise).  Each keeps a plain-integer
``launches`` count, bumped once per kernel launch and nowhere else.
"""
