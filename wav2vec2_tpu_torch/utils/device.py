"""Device selection (counterpart of `wav2vec2_tpu.utils.device`).

One rule for the CLI, the serving daemon and `doctor`: the port runs on
`cuda` or on `cpu`, and on `cuda` only where a CUDA device is present.
There is no fall-back to the CPU: the JAX package's `ensure_backend`
falls back to it when the accelerator fails to initialise, the port
raises and says to pass `--device cpu`.

The first CUDA initialisation runs under the JAX package's watchdog: a
warning after 120 s, and a hard abort once WAV2VEC2_DEVICE_INIT_TIMEOUT_S
is exceeded, for unattended runs that must fail fast.

There is no `enable_compilation_cache`: eager PyTorch compiles nothing
per shape, and the CUDA kernel library is already cached on disk under
`build/torch_kernels/` (`ops/cuda_build.py`).
"""

from __future__ import annotations

import logging

import torch

from ..errors import InvalidInputError

logger = logging.getLogger(__name__)


def _init_watchdog(warn_after: float = 120.0):
    """Device initialisation can HANG (not error) when the driver or the
    card is wedged. Warn the operator with a remediation hint, and
    hard-abort if WAV2VEC2_DEVICE_INIT_TIMEOUT_S is set and exceeded.
    Returns a cancel callable."""
    import os
    import sys
    import threading

    done = threading.Event()
    deadline = float(os.environ.get("WAV2VEC2_DEVICE_INIT_TIMEOUT_S", "0"))

    def fire():
        if done.wait(warn_after):
            return
        logger.warning(
            "device initialization has not returned after %.0f s — the "
            "GPU driver or card may be unresponsive (a wedged device hangs "
            "instead of erroring). Pass --device cpu to run on CPU, or set "
            "WAV2VEC2_DEVICE_INIT_TIMEOUT_S to abort unattended runs.",
            warn_after,
        )
        if deadline > warn_after and not done.wait(deadline - warn_after):
            print(
                f"device init watchdog: no CUDA device after {deadline:.0f}s — "
                "aborting (WAV2VEC2_DEVICE_INIT_TIMEOUT_S)",
                file=sys.stderr,
            )
            sys.stderr.flush()
            os._exit(3)

    threading.Thread(target=fire, daemon=True).start()
    return done.set


def select_device(name: str | torch.device = "cuda") -> torch.device:
    """The torch device `name` names: cuda (any index) or cpu. Raises
    InvalidInputError for any other device, or for cuda where torch sees no
    CUDA device. The first CUDA device selected in the process is
    initialised (the context and one small allocation) under the
    watchdog."""
    try:
        device = torch.device(name)
    except (RuntimeError, TypeError):
        device = None
    if device is None or device.type not in ("cuda", "cpu"):
        raise InvalidInputError(f"unknown --device {name!r}; use cuda or cpu")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise InvalidInputError(
                f"--device {name} asked for a CUDA device, but torch sees none; "
                "pass --device cpu to run on the CPU"
            )
        cancel = _init_watchdog()
        try:
            torch.cuda.init()
            torch.empty(1, device=device)
        finally:
            cancel()
    return device


def device_label(device: torch.device) -> str:
    """The card's name for a CUDA device, "cpu" otherwise."""
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
