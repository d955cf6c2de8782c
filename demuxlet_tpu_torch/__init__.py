"""PyTorch + CUDA port of demuxlet-tpu (Hopper, sm_90a).

``DemuxEngine.run_compact`` runs end to end on one device in exact mode
(the CLI default: f64 front K2' and f64 pair search K3',
``csrc/front_exact.cu`` and ``csrc/pair_exact.cu``) and in fast mode (f32
pair search K1, ``csrc/pair_fast.cu``): host wire-v2 pack -> device wire
decode -> front -> pair-search kernel -> singlet term -> device decision
pass -> packed compact rows -> host render.

The shared host layers (``demuxlet_tpu.{io,host,native}``,
``models/outputs.py``, ``ops/luts.py``, ``utils/`` and ``oracle/``) never
import JAX and are imported, not copied. Nothing here imports JAX, and
importing the package builds nothing: each CUDA kernel is compiled by nvcc
at its first launch (``kernels/build.py``).
"""
