"""PyTorch/CUDA port of the honours_tpu batched codec engines.

The package runs the batched encode and decode of the JAX package's 21
engine codecs (engine/runner.py ENGINE_CODECS), of its 25 range-coder
codecs (RC_CODECS) and of its 11 per-read entropy codecs
(ENTROPY_CODECS: rccdf, huffman and shuffman over the vb containers),
which the JAX package runs on the host only, on an NVIDIA Hopper card,
with hand-written CUDA kernels (csrc/) in place of the JAX package's
Pallas kernels, and for the stall segmenter, the rice and Huffman
decodes, the Huffman table build, the range coder and rccdf's rANS,
which the JAX package runs as a lax.scan and on the host.
Every kernel wrapper routes by the device of the tensors it is given:
CUDA tensors launch the kernel, CPU tensors run the plain PyTorch
version beside it.  Entry points: honours_tpu_torch.engine.runner
.press_signals / depress_signals, and the command line
`python -m honours_tpu_torch press|depress|bench|analyze|codecs`
(cli.py) over BLOW5 files (io/blow5.py), with the reference-TSV bench
(bench/harness.py) and the signal statistics report (analysis.py).
Settings, with the JAX package's HTPU_* environment overrides, are in
utils/config.py.
"""
