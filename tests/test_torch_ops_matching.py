"""The port's matching ops (picopose_tpu_torch/ops/matching.py) and resize
against the JAX package: the Pallas score kernel (interpret mode), the XLA
``match_templates``, and ``feature_similarity_volume``.

Whole (B, N) score tables are compared, not only top-k ids, so near-ties
between random views cannot make a test flaky.  Tolerances: fp32 scores
differ only in summation order (1e-5; scores are O(0.1)); with bf16
operands both sides multiply the same bf16 values and sum in fp32, so the
same 1e-5 holds against the Pallas kernel on bf16 inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picopose_tpu.ops import matching as jm
from picopose_tpu.ops.pallas.matching import match_scores_pallas
from picopose_tpu.ops.resize import resize_bilinear as j_bilinear
from picopose_tpu.ops.resize import resize_nearest as j_nearest
from picopose_tpu_torch import kernels
from picopose_tpu_torch.ops import matching as tm
from picopose_tpu_torch.ops.resize import resize_bilinear, resize_nearest


def _features(B, N, h, C, seed=0, shared=0.0):
    rng = np.random.default_rng(seed)
    tem = rng.normal(size=(N, h, h, C)).astype(np.float32)
    qry = rng.normal(size=(B, h, h, C)).astype(np.float32)
    if shared:  # make some views clearly better matches than others
        qry[: min(B, N)] += shared * tem[: min(B, N)]
    mask = (rng.random((B, 224, 224)) > 0.4).astype(np.float32)
    return tem, qry, mask


def _normalized(tem, qry, mask, dtype=jnp.float32):
    N, h, _, C = tem.shape
    B, S = qry.shape[0], h * h
    q = jm.l2_normalize(jnp.asarray(qry), axis=-1).reshape(B, S, C).astype(dtype)
    qm = j_nearest(jnp.asarray(mask), (h, h)).reshape(B, S)
    t = jm.l2_normalize(jnp.asarray(tem), axis=-1).reshape(N, S, C).astype(dtype)
    return q, qm, t


def _t(a):
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_scores_match_pallas(dtype):
    tem, qry, mask = _features(2, 11, 16, 64, shared=0.5)  # 11 views: two chunks
    q, qm, t = _normalized(tem, qry, mask, jnp.dtype(dtype))
    ref = np.asarray(match_scores_pallas(q, qm, t, interpret=True))
    tdt = getattr(torch, dtype)
    got = tm.match_scores_plain(_t(q).to(tdt), _t(qm), _t(t).to(tdt))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


def test_match_templates_matches_xla_table():
    """Full score table (topk = N) and ids against the XLA path."""
    B, N, h, C = 2, 7, 16, 32
    tem, qry, mask = _features(B, N, h, C, seed=3, shared=0.7)
    ref_s, ref_i = jm.match_templates(
        jnp.asarray(tem), jnp.asarray(qry), jnp.asarray(mask), topk=N, impl="xla"
    )
    got_s, got_i = tm.match_templates(
        torch.from_numpy(tem), torch.from_numpy(qry), torch.from_numpy(mask), topk=N
    )
    table = lambda s, i: np.take_along_axis(np.asarray(s), np.argsort(np.asarray(i), 1), 1)
    np.testing.assert_allclose(table(got_s, got_i), table(ref_s, ref_i), atol=1e-5)
    # the planted matches are clear winners: the top-2 ids agree exactly
    np.testing.assert_array_equal(got_i[:, :2].numpy(), np.asarray(ref_i)[:, :2])


def test_top_k_breaks_ties_to_lower_index():
    scores = torch.tensor([[0.0, 0.5, 0.0, 0.5, 0.25]])
    vals, ids = tm.top_k(scores, 4)
    assert ids.tolist() == [[1, 3, 4, 0]]
    assert vals.tolist() == [[0.5, 0.5, 0.25, 0.0]]


def test_feature_similarity_volume_matches_jax():
    rng = np.random.default_rng(5)
    tem = rng.normal(size=(3, 16, 16, 32)).astype(np.float32)
    qry = rng.normal(size=(3, 16, 16, 32)).astype(np.float32)
    mask = (rng.random((3, 224, 224)) > 0.5).astype(np.float32)
    ref = np.asarray(jm.feature_similarity_volume(*(jnp.asarray(a) for a in (tem, qry, mask))))
    got = tm.feature_similarity_volume(*(torch.from_numpy(a) for a in (tem, qry, mask)))
    assert got.shape == (3, 16, 16, 256)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)


@pytest.mark.parametrize("out_hw", [(16, 16), (37, 23), (64, 64), (1, 5)])
def test_resize_matches_jax(out_hw):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 32, 32, 5)).astype(np.float32)
    m = (rng.random((2, 224, 224)) > 0.5).astype(np.float32)
    np.testing.assert_array_equal(
        resize_nearest(torch.from_numpy(m), out_hw).numpy(), np.asarray(j_nearest(jnp.asarray(m), out_hw))
    )
    np.testing.assert_allclose(
        resize_bilinear(torch.from_numpy(x), out_hw).numpy(),
        np.asarray(j_bilinear(jnp.asarray(x), out_hw, align_corners=True)),
        atol=1e-6,
    )


def test_cpu_dispatch_is_plain_and_launches_nothing():
    tem, qry, mask = _features(2, 3, 16, 32)
    q, qm, t = (_t(a) for a in _normalized(tem, qry, mask))
    kernels.reset_launches()
    assert torch.equal(tm.match_scores(q, qm, t), tm.match_scores_plain(q, qm, t))
    assert kernels.LAUNCHES["match_scores"] == 0
    with pytest.raises(ValueError):
        tm.match_scores_cuda(q, qm, t)



def test_plain_scores_match_pallas_at_the_loops_shape_fp32():
    """S = 256, C = 384 (the accuracy loop's ViT-S bank) in fp32, with
    exact first-index ties planted (view column 5 equal to column 0, so
    the row argmax stays 0; query row 3 equal to row 0, so the column
    argmax stays 0), masked rows and one query with every row masked
    (score 0), against the Pallas kernel (1e-5)."""
    B, N, S, C = 4, 12, 256, 384
    rng = np.random.default_rng(16)
    t = rng.normal(size=(N, S, C)).astype(np.float32)
    t[:, 5] = t[:, 0]
    q = t[:B] + 0.5 * rng.normal(size=(B, S, C)).astype(np.float32)
    q[:, 3] = q[:, 0]
    qm = (rng.random((B, S)) > 0.3).astype(np.float32)
    qm[:, 0] = qm[:, 3] = 1.0
    qm[1] = 0.0
    jq = jm.l2_normalize(jnp.asarray(q), axis=-1)
    jt = jm.l2_normalize(jnp.asarray(t), axis=-1)
    ref = np.asarray(match_scores_pallas(jq, jnp.asarray(qm), jt, interpret=True))
    got = tm.match_scores(_t(jq), torch.from_numpy(qm), _t(jt)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    assert (got[1] == 0).all() and (ref[1] == 0).all()
    np.testing.assert_array_equal(got[[0, 2, 3]].argmax(1), [0, 2, 3])
