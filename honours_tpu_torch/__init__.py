"""PyTorch/CUDA port of the honours_tpu batched codec engines.

The package runs the batched encode and decode of drans_vbbe21_zd,
srans3_vbbe21_zd and the VBZ container's svb12_zd / svb12 on an NVIDIA
Hopper card, with hand-written CUDA kernels (csrc/) in place of the JAX
package's Pallas kernels.  Every kernel wrapper routes by the device of
the tensors it is given: CUDA tensors launch the kernel, CPU tensors
run the plain PyTorch version beside it.  Entry points:
honours_tpu_torch.engine.runner.press_signals / depress_signals.
"""
