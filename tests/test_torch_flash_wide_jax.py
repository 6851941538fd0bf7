"""Heads wider than 512 in the port's flash attention on the CPU: the
plain versions at D = 640 and 1024 against the JAX Pallas kernels in
interpret mode, in float32, bfloat16 and float16, causal with key lengths
and without masks, under `tests/test_torch_flash_wide.py`'s tolerance
rule (its cases, in a file of their own so that each file stays within a
minute)."""
import pytest

import test_torch_flash_wide as wide


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")


@pytest.mark.parametrize("d", [640, 1024])
@pytest.mark.parametrize("dtype", list(wide.DTYPES))
@wide.MASKS
def test_wider_plain_matches_jax_kernels(interpret, d, dtype, causal, lens):
    """`test_wide_plain_matches_jax_kernels` at D = 640 and 1024: out,
    lse, dQ, dK, dV against `_flash_fwd_pallas` / `_flash_bwd_pallas`."""
    wide.plain_matches_jax(d, dtype, causal, lens)
