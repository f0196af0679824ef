"""The port's stable top-k against ``lax.top_k`` and
``hierarchical_top_k``: values and indices bitwise on inputs full of ties
(snapped scores, quantized to 1/16, ``-inf`` lanes), in f32 and bf16."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from mx_rcnn_tpu.ops.topk import hierarchical_top_k
from mx_rcnn_tpu_torch.ops.topk import top_k

# Small tensors: a few threads each keep parallel test workers from
# oversubscribing the cores.
torch.set_num_threads(2)


def _tied(rng, n):
    s = np.round(rng.rand(n).astype(np.float32) * 16) / 16
    s[::7] = -np.inf
    return s.astype(np.float32)


@pytest.mark.parametrize("n,k", [(10, 10), (1000, 100), (5000, 1000)])
def test_top_k_matches_lax_top_k_on_ties(n, k):
    s = _tied(np.random.RandomState(n), n)
    jv, ji = lax.top_k(jnp.asarray(s), k)
    tv, ti = top_k(torch.from_numpy(s), k)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_top_k_matches_hierarchical_top_k_blocked():
    s = _tied(np.random.RandomState(1), 9000)
    jv, ji = hierarchical_top_k(jnp.asarray(s), 700, block=1024)
    tv, ti = top_k(torch.from_numpy(s), 700)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_top_k_bf16_batched_rows():
    s = np.random.RandomState(2).rand(3, 4000).astype(np.float32)
    jx = jnp.asarray(s).astype(jnp.bfloat16)
    jv, ji = lax.top_k(jx, 500)
    tv, ti = top_k(torch.from_numpy(s).to(torch.bfloat16), 500)
    np.testing.assert_array_equal(tv.float().numpy(), np.asarray(jv.astype(jnp.float32)))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_top_k_rejects_k_past_the_operand():
    with pytest.raises(ValueError):
        top_k(torch.zeros(4), 5)
