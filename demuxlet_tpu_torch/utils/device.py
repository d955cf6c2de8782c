"""Device selection for the port (counterpart of ``utils/jaxcfg.py`` and the
platform switch in ``demuxlet_tpu/cli.py:main``)."""

from __future__ import annotations

import torch

from demuxlet_tpu_torch.utils.logging_utils import DemuxError


def resolve_device(name: str) -> torch.device:
    """``"auto"``/``"cuda"``: the first CUDA device, or DemuxError when
    there is none (the port never falls back to the CPU). ``"cpu"``: the
    plain PyTorch versions of every kernel, for tests.

    Turns TF32 off for float32 matmuls and cuDNN, the counterpart of the
    JAX package's ``precision=HIGHEST`` (pallas_pair.py:1115-1121): the
    fast-mode 2e-5 contract does not survive TF32's 10-bit mantissa."""
    if name == "cpu":
        return torch.device("cpu")
    if name not in ("auto", "cuda"):
        raise DemuxError(
            f"--device {name} is not supported by the PyTorch port "
            "(use auto/cuda or cpu)"
        )
    if not torch.cuda.is_available():
        raise DemuxError(
            "no CUDA device is available; the PyTorch port runs on a CUDA "
            "card (--device cpu runs the plain versions for tests)"
        )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def settle_host_math() -> None:
    """One call into the CPU's vector math library on this thread, before
    any threaded one. MKL's vector math (torch's CPU exp and log, f32 and
    f64) initialises itself on its first call; when that call comes from
    several of torch's intra-op threads at once, one thread's share of the
    tensor (one 2048-element grain) can run at reduced accuracy, up to
    3.3e-9 relative in exp instead of under one ulp, in about 3 of 100
    fresh processes. A one-element exp here, which runs on this thread
    alone, settles the library for every thread of the process. The
    package's ``__init__`` calls it once."""
    torch.exp(torch.zeros(1, dtype=torch.float64))
