"""PyTorch + CUDA port of demuxlet-tpu (Hopper, sm_90a).

Slice 1 covers fast-mode ``DemuxEngine.run_compact`` end to end on one
device: host wire-v2 pack -> device wire decode -> front -> pair-search
kernel (hand-written CUDA, ``csrc/pair_fast.cu``) -> singlet term ->
device decision pass -> packed compact rows -> host render.

The shared host layers (``demuxlet_tpu.{io,host,native}``,
``models/outputs.py``, ``ops/luts.py``, ``utils/`` and ``oracle/``) never
import JAX and are imported, not copied. Nothing here imports JAX, and
importing the package builds nothing: the CUDA kernel is compiled by nvcc
at its first launch (``kernels/build.py``).
"""
