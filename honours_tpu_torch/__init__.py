"""PyTorch/CUDA port of the honours_tpu batched codec engines.

The package runs the batched encode and decode of every codec of the
JAX package's registry (106, engine/runner.py CODECS): its 21 engine
codecs (ENGINE_CODECS), and the 25 range-coder codecs (RC_CODECS), 11
per-read entropy codecs (ENTROPY_CODECS: rccdf, huffman and shuffman
over the vb containers), 16 raw-sample and bit-packing codecs
(RAW_CODECS), turbopfor, flac and none (BLOCK_CODECS) and 30 byte
layers (LAYER_CODECS, the layer itself on the host) that the JAX
package runs on the host only, on an NVIDIA Hopper card,
with hand-written CUDA kernels (csrc/) in place of the JAX package's
Pallas kernels, and for the stall segmenter, the rice, Huffman and
flac decodes, the Huffman table build, the range coder, rccdf's rANS,
the bit packing, the flats partition and the segment-header walk, which
the JAX package runs as a lax.scan and on the host.
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
