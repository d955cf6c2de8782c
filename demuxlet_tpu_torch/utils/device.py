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
