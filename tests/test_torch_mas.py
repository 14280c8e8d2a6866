"""The port's monotonic alignment search against the JAX package, exactly.

`ops/mas.py::maximum_path_plain` (what the port runs on the CPU, and what the
MAS kernel is held to on the card) must give the same one-hot paths as the
scalar oracle `maximum_path_numpy`, the JAX scan implementation and the JAX
Pallas kernel in interpret mode: every cell is the same fp32 max and add, so
the tolerance is zero.  Ragged batches include items with t_y < t_x and an
item of length 1."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matcha_tts_tpu.ops.mas import maximum_path as jmaximum_path
from matcha_tts_tpu.ops.pallas.mas import maximum_path_pallas
from matcha_tts_tpu_torch.ops import mas


def _case(b, t_x, t_y, seed):
    rng = np.random.default_rng(seed)
    value = (rng.standard_normal((b, t_x, t_y)) * 3.0 - 50.0).astype(np.float32)
    tx = rng.integers(1, t_x + 1, b)
    ty = np.minimum(tx * 3 + rng.integers(0, t_y, b), t_y)
    tx[0], ty[0] = t_x, t_y
    tx[1], ty[1] = t_x, max(1, t_x - 2)  # t_y < t_x
    tx[2], ty[2] = 1, 1
    mask = ((np.arange(t_x)[None, :, None] < tx[:, None, None])
            & (np.arange(t_y)[None, None, :] < ty[:, None, None])).astype(np.float32)
    return value, mask


CASES = [(5, 6, 17, 0), (6, 13, 40, 1), (4, 24, 72, 2)]


@pytest.mark.parametrize("b,t_x,t_y,seed", CASES)
def test_plain_equals_numpy_oracle(b, t_x, t_y, seed):
    value, mask = _case(b, t_x, t_y, seed)
    got = mas.maximum_path(torch.from_numpy(value), torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, mas.maximum_path_numpy(value, mask))


@pytest.mark.parametrize("b,t_x,t_y,seed", CASES)
def test_plain_equals_jax_scan_and_pallas_interpret(b, t_x, t_y, seed):
    value, mask = _case(b, t_x, t_y, seed)
    got = mas.maximum_path_plain(torch.from_numpy(value), torch.from_numpy(mask)).numpy()
    scan = np.asarray(jmaximum_path(jnp.asarray(value), jnp.asarray(mask), impl="scan"))
    pallas = np.asarray(maximum_path_pallas(jnp.asarray(value), jnp.asarray(mask),
                                            interpret=True))
    np.testing.assert_array_equal(got, scan)
    np.testing.assert_array_equal(got, pallas)


def test_path_is_monotonic_one_hot_and_keeps_dtype():
    value, mask = _case(4, 10, 30, 3)
    got = mas.maximum_path(torch.from_numpy(value).bfloat16(), torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16
    p = got.float().numpy()
    tx, ty = mask[:, :, 0].sum(1).astype(int), mask[:, 0, :].sum(1).astype(int)
    for i in range(4):
        if ty[i] < tx[i]:
            continue
        cols = p[i, :tx[i], :ty[i]]
        assert (cols.sum(0) == 1).all()  # one token per frame
        idx = cols.argmax(0)
        assert idx[0] == 0 and idx[-1] == tx[i] - 1
        assert ((np.diff(idx) == 0) | (np.diff(idx) == 1)).all()
        assert p[i].sum() == ty[i]  # nothing outside the valid region


def test_wrapper_refuses_non_cuda_tensors():
    """The kernel wrapper takes CUDA tensors only: on the CPU the dispatch
    runs the plain version, and nothing falls back silently."""
    from matcha_tts_tpu_torch.ops import mas_cuda

    value, mask = _case(3, 4, 8, 4)
    with pytest.raises(ValueError, match="CUDA"):
        mas_cuda.maximum_path_cuda(torch.from_numpy(value), torch.from_numpy(mask))
    n0 = mas_cuda.LAUNCHES["mas"]
    mas.maximum_path(torch.from_numpy(value), torch.from_numpy(mask))
    assert mas_cuda.LAUNCHES["mas"] == n0
