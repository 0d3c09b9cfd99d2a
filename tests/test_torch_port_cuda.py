"""The port's CUDA kernels on the card, marked `cuda`: they skip without an
NVIDIA GPU, since a CUDA kernel has no CPU mode (the CPU tests hold the
plain versions to the JAX package instead).

This file imports neither jax nor the JAX package, so it also runs on a GPU
machine that has only the port's dependencies; there, skip `conftest.py`
(it configures JAX):

    python -m pytest --noconftest tests/test_torch_port_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from chip_smoke import check_kernel, kernel_cases
from wav2vec2_tpu_torch.ops import viterbi_cuda


@pytest.mark.cuda
def test_k1_kernel_matches_plain_on_the_card():
    """K1's paths are bit-identical to its plain PyTorch version (every row
    and frame) and to viterbi_numpy (a few rows) at the serving shape, a
    ragged-t_len batch, the band and skip-rule edge cases and a long
    utterance; one launch per case."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the K1 CUDA kernel has no CPU mode")
    cases = kernel_cases(np.random.default_rng(0))
    before = viterbi_cuda.viterbi_batch.launches
    assert check_kernel(torch.device("cuda", 0), cases) == 0
    torch.cuda.synchronize()
    assert viterbi_cuda.viterbi_batch.launches == before + len(cases)
