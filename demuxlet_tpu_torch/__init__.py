"""PyTorch + CUDA port of demuxlet-tpu (Hopper, sm_90a).

``DemuxEngine.run_compact`` runs end to end on one device in exact mode
(the CLI default: f64 front K2' and f64 pair search K3',
``csrc/front_exact.cu`` and ``csrc/pair_exact.cu``; pools with
V*V*A > 384 run the tiled f64 pair search K7' and its O(V) companion K6',
``csrc/pair_tiled_exact.cu`` and ``csrc/extras_exact.cu``) and in fast
mode (f32 pair search K1, ``csrc/pair_fast.cu``): host wire-v2 pack ->
device wire decode -> front -> pair-search kernel -> singlet term ->
device decision pass -> packed compact rows -> host render.

The host layers are the port's own copies of the JAX package's JAX-free
modules (``io/``, ``host/``, ``native/``, ``models/outputs.py``,
``ops/luts.py``, ``utils/``, ``cli_common.py`` and ``oracle.py``, the
copy of ``oracle/numpy_oracle.py``); only their import paths differ, and
tests/test_torch_host.py pins each to its original. Nothing here imports
JAX, ``demuxlet_tpu`` or ``oracle``, and importing the package builds
nothing: each CUDA kernel is compiled by nvcc at its first launch
(``kernels/build.py``).
"""
