"""The port's MoCo functions against the JAX package's (1e-6), inputs from a
numpy seed: normalisation, logits, loss, the ring write and its wrap, the
momentum update, the queue's initial draw."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from frequency_wised_all_in_one_image_restoration_model_tpu.models import (
    moco as jmoco)
from frequency_wised_all_in_one_image_restoration_model_tpu_torch.models import (
    moco as tmoco)

L, B, DIM, K = 3, 4, 8, 12
TOL = 1e-6


@pytest.fixture
def rng():
    return np.random.default_rng(5)


def _a(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_normalize_bands_matches(rng):
    q = _a(rng, L, B, DIM)
    q[0, 0] = 0.0  # the clamp at 1e-12 keeps a zero row finite
    got = tmoco.normalize_bands(torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmoco.normalize_bands(
        jnp.asarray(q))), rtol=TOL, atol=TOL)
    assert np.isfinite(got).all() and np.all(got[0, 0] == 0.0)


def _unit(rng, *shape, axis=-1):
    a = _a(rng, *shape)
    return a / np.linalg.norm(a, axis=axis, keepdims=True)


def test_contrastive_logits_and_loss_match(rng):
    q, k = _unit(rng, L, B, DIM), _unit(rng, L, B, DIM)
    queue = _unit(rng, L, DIM, K, axis=1)
    got = tmoco.contrastive_logits(*map(torch.from_numpy, (q, k, queue)))
    want = jmoco.contrastive_logits(*map(jnp.asarray, (q, k, queue)))
    assert tuple(got.shape) == (L, B, 1 + K)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=2e-6)  # logits reach 1 / 0.07
    np.testing.assert_allclose(
        float(tmoco.contrastive_loss(got)),
        float(jmoco.contrastive_loss(want)), rtol=TOL, atol=TOL)


def test_logits_take_no_gradient_through_the_queue(rng):
    q = torch.from_numpy(_unit(rng, L, B, DIM)).requires_grad_()
    k = torch.from_numpy(_unit(rng, L, B, DIM))
    queue = torch.from_numpy(_unit(rng, L, DIM, K, axis=1)).requires_grad_()
    tmoco.contrastive_loss(tmoco.contrastive_logits(q, k, queue)).backward()
    assert q.grad is not None and queue.grad is None


@pytest.mark.parametrize("steps", [1, 3, 4])
def test_ring_write_and_wrap_match(rng, steps):
    queue = _unit(rng, L, DIM, K, axis=1)
    tq, tp = torch.from_numpy(queue.copy()), torch.zeros((), dtype=torch.int64)
    jq, jp = jnp.asarray(queue), jnp.zeros((), jnp.int32)
    for _ in range(steps):
        keys = _unit(rng, L, B, DIM)
        tq, tp = tmoco.dequeue_and_enqueue(tq, tp, torch.from_numpy(keys))
        jq, jp = jmoco.dequeue_and_enqueue(jq, jp, jnp.asarray(keys))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert int(tp) == int(jp) == (steps * B) % K


def test_ring_write_needs_a_whole_number_of_batches(rng):
    with pytest.raises(ValueError):
        tmoco.dequeue_and_enqueue(torch.zeros(L, DIM, K + 1),
                                  torch.zeros((), dtype=torch.int64),
                                  torch.zeros(L, B, DIM))


def test_momentum_update_matches(rng):
    wk, wq = _a(rng, 5, 3), _a(rng, 5, 3)
    bk, bq = _a(rng, 5), _a(rng, 5)
    key, query = nn.Linear(3, 5), nn.Linear(3, 5)
    with torch.no_grad():
        key.weight.copy_(torch.from_numpy(wk)); key.bias.copy_(torch.from_numpy(bk))
        query.weight.copy_(torch.from_numpy(wq)); query.bias.copy_(torch.from_numpy(bq))
    tmoco.momentum_update(key, query)
    want = jmoco.momentum_update({"w": jnp.asarray(wk), "b": jnp.asarray(bk)},
                                 {"w": jnp.asarray(wq), "b": jnp.asarray(bq)})
    np.testing.assert_allclose(key.weight.detach().numpy(), np.asarray(want["w"]),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(key.bias.detach().numpy(), np.asarray(want["b"]),
                               rtol=TOL, atol=TOL)
    assert torch.equal(query.weight, torch.from_numpy(wq))


def test_init_queue_is_normalised_and_seeded():
    gen = lambda: torch.Generator().manual_seed(9)
    a, b = tmoco.init_queue(gen(), L, DIM, K), tmoco.init_queue(gen(), L, DIM, K)
    assert torch.equal(a, b) and tuple(a.shape) == (L, DIM, K)
    np.testing.assert_allclose(torch.linalg.vector_norm(a, dim=1).numpy(), 1.0,
                               atol=1e-6)
