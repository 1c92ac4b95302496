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


# ---- per-item (B, N, h, w, C) banks -----------------------------------------


def _per_item(B, N, h, C, seed=17):
    """Per-item banks whose view v of item b is noise plus (0.1 + v / N)
    times the item's query: the scores rise with v in steps far above
    the 1e-5 tolerance, so the whole top-N order is fixed."""
    rng = np.random.default_rng(seed)
    qry = rng.normal(size=(B, h, h, C)).astype(np.float32)
    tem = rng.normal(size=(B, N, h, h, C)).astype(np.float32)
    tem += (0.1 + np.arange(N) / N)[None, :, None, None, None].astype(np.float32) * 2.0 * qry[:, None]
    mask = (rng.random((B, 224, 224)) > 0.4).astype(np.float32)
    return tem, qry, mask


@pytest.mark.parametrize("h", [4, 16])
def test_per_item_banks_match_xla(h):
    """(B = 3, N = 13) per-item banks (13 views: one whole chunk of 8 and a
    part) against the JAX XLA path: every score within 1e-5 and the whole
    id order equal."""
    B, N, C = 3, 13, 64
    tem, qry, mask = _per_item(B, N, h, C)
    ref_s, ref_i = jm.match_templates(jnp.asarray(tem), jnp.asarray(qry), jnp.asarray(mask), topk=N, impl="xla")
    got_s, got_i = tm.match_templates(torch.from_numpy(tem), torch.from_numpy(qry), torch.from_numpy(mask), topk=N)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s), atol=1e-5)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    assert (np.diff(np.asarray(ref_s), axis=1) < -1e-4).all()  # no near ties decide the order


@pytest.mark.parametrize("view_chunk", [1, 5, 8, 13, 32])
def test_per_item_scores_do_not_depend_on_the_chunk(view_chunk):
    """N = 13 with chunks that do and do not divide it: the same scores
    (the chunk only bounds the table held at once) and ids."""
    tem, qry, mask = (torch.from_numpy(a) for a in _per_item(2, 13, 16, 32, seed=4))
    ref_s, ref_i = tm.match_templates(tem, qry, mask, topk=13)
    got_s, got_i = tm.match_templates(tem, qry, mask, topk=13, view_chunk=view_chunk)
    np.testing.assert_allclose(got_s.numpy(), ref_s.numpy(), atol=1e-6)
    assert torch.equal(got_i, ref_i)


def test_repeated_shared_bank_gives_the_shared_scores():
    """B copies of a shared fp32 bank, as a per-item bank, score as the
    shared bank does (the plain version of the kernel there): 1e-5."""
    B, N, h, C = 3, 11, 16, 64
    tem, qry, mask = _features(B, N, h, C, seed=9, shared=0.8)
    shared_s, shared_i = tm.match_templates(torch.from_numpy(tem), torch.from_numpy(qry), torch.from_numpy(mask),
                                            topk=N)
    per_item = torch.from_numpy(tem)[None].expand(B, *tem.shape)
    got_s, got_i = tm.match_templates(per_item, torch.from_numpy(qry), torch.from_numpy(mask), topk=N)
    table = lambda s, i: np.take_along_axis(s.numpy(), np.argsort(i.numpy(), 1), 1)
    np.testing.assert_allclose(table(got_s, got_i), table(shared_s, shared_i), atol=1e-5)
    np.testing.assert_array_equal(got_i[:, :2].numpy(), shared_i[:, :2].numpy())  # the planted matches


@pytest.mark.parametrize("env", ["PICOPOSE_MATCH_INT8", "PICOPOSE_MATCH_FP32"])
def test_serving_modes_leave_per_item_banks_alone(env, monkeypatch):
    """The serving modes pick the kernel's operands (a shared bank's); a
    per-item bank, bf16 included, takes fp32 operands under either, as the
    JAX package's XLA path does, and matches that path (1e-5)."""
    tem, qry, mask = _per_item(2, 9, 16, 32, seed=6)
    tem16 = torch.from_numpy(tem).to(torch.bfloat16)
    args = (torch.from_numpy(qry), torch.from_numpy(mask))
    plain_s, plain_i = tm.match_templates(tem16, *args, topk=9, mode=None)
    monkeypatch.setenv(env, "1")
    got_s, got_i = tm.match_templates(tem16, *args, topk=9)
    assert torch.equal(got_s, plain_s) and torch.equal(got_i, plain_i)
    ref_s, _ = jm.match_templates(jnp.asarray(tem16.float().numpy()).astype(jnp.bfloat16), jnp.asarray(qry),
                                  jnp.asarray(mask), topk=9, impl="xla")
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s), atol=1e-5)
    kernels.reset_launches()
    tm.match_templates(tem16, *args, topk=9)
    assert not kernels.LAUNCHES


def test_per_item_banks_need_one_bank_per_query():
    tem, qry, mask = _per_item(3, 4, 4, 16)
    with pytest.raises(ValueError, match="per-item banks for 3 items, 2 queries"):
        tm.match_templates(torch.from_numpy(tem), torch.from_numpy(qry[:2]), torch.from_numpy(mask[:2]))
