"""The port's opt-in serving modes against the JAX package's, on the CPU.

  * precast (utils/precast.py): bf16 weight storage leaves the bf16
    features, DPT pyramids and flows bitwise equal, and exactly the listed
    parameters stay fp32;
  * int8 / fp32-operand matching (ops/matching.py): the int8
    ``match_scores_plain`` against ``match_scores_pallas`` on int8
    operands in interpret mode, quantised as tests/test_matching_pallas.py
    does (the JAX ``match_templates`` takes its int8 branch only on a TPU);
    the fp32-operand mode on a bf16 bank against the JAX XLA path, which
    scores fp32 operands;
  * ``quantized_conv`` (ops/qconv.py) against the JAX ``quantized_conv``;
  * the flow decoder with ``quantize=True`` and with ``fuse_xheads=False``
    against the JAX ``FlowDecoder`` at the same weights.

Tolerances (measured max errors in brackets): precast bitwise; int8
scores within 1e-6 of the Pallas kernel's, which sums the row maxima in
another order [1.5e-8]; fp32-operand scores within 1e-5 of the XLA
path's [6.0e-8], with equal top-k ids; ``quantized_conv`` bitwise in fp32
and bf16 (the same int8 values, exact s32 sums, the same dequantisation
order); the int8 motion encoder and XHeads within 1e-5 relative RMS
[6.3e-7]; the int8
decoder as ``test_int8_flow_decoder_matches_jax`` says; the unfused
decoder within 1e-3 + 1e-4 relative, as tests/test_torch_flow.py holds
the fused one.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import SMALL, assert_close, random_flax_variables

from picopose_tpu.models import PicoPose as JaxPicoPose
from picopose_tpu.models.flow import MotionEncoder as JaxMotionEncoder
from picopose_tpu.models.flow import XHead as JaxXHead
from picopose_tpu.ops.matching import l2_normalize as jax_l2_normalize
from picopose_tpu.ops.matching import match_templates as jax_match_templates
from picopose_tpu.ops.pallas.matching import match_scores_pallas
from picopose_tpu.ops.qconv import quantized_conv as jax_quantized_conv
from picopose_tpu.ops.resize import resize_nearest as jax_resize_nearest
from picopose_tpu_torch.models import PicoPose
from picopose_tpu_torch.ops import matching as M
from picopose_tpu_torch.ops.qconv import quantized_conv
from picopose_tpu_torch.utils.precast import precast_inference_params
from picopose_tpu_torch.utils.weights import init_random_, load_flax_variables


def _rel_rms(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


# ---- precast ------------------------------------------------------------------


def _is_precast(name: str) -> bool:
    """The parameters precast stores in bf16, by their state-dict names."""
    if not name.startswith(("feature_extractor.", "dpt_head.", "flow_decoder.")):
        return False
    last = name.rsplit(".", 1)[-1]
    if last in ("gamma", "cls_token"):
        return True
    norm = any(f".{n}" in name for n in ("norm1.", "norm2.", "bn1.", "bn2.", "proj_bn."))
    return last in ("weight", "bias") and not norm


@pytest.fixture(scope="module")
def bf16_models():
    fp32 = PicoPose(**SMALL, compute_dtype=torch.bfloat16, device="cpu")
    init_random_(fp32, 0)
    return fp32, precast_inference_params(copy.deepcopy(fp32))


def test_precast_stores_exactly_the_listed_parameters_in_bf16(bf16_models):
    fp32, cast = bf16_models
    state = cast.state_dict()
    bf16 = {k for k, v in state.items() if v.dtype == torch.bfloat16}
    assert bf16 == {k for k in state if _is_precast(k)}
    for k in ("feature_extractor.dinov2.pos_embed", "feature_extractor.dinov2.blocks.0.norm1.weight",
              "dpt_head.refinenet2.resConfUnit1.bn1.running_var", "flow_decoder.proj_bn.0.bias",
              "affine_regressor.fc1.weight", "affine_regressor.gn0.weight"):
        assert state[k].dtype == torch.float32, k
    for k in ("feature_extractor.dinov2.cls_token", "feature_extractor.dinov2.blocks.1.ls2.gamma",
              "feature_extractor.dinov2.patch_embed.weight", "dpt_head.resize_0.bias",
              "flow_decoder.flow_pred.2.layers_0.weight"):
        assert state[k].dtype == torch.bfloat16, k
    assert all(v.dtype == torch.float32 for v in fp32.state_dict().values())  # a copy was cast


def test_precast_outputs_are_bitwise_equal(bf16_models):
    fp32, cast = bf16_models
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.normal(size=(2, 224, 224, 3)).astype(np.float32))
    flow = torch.from_numpy(rng.normal(size=(2, 16, 16, 2)).astype(np.float32))
    cert = torch.zeros(2, 16, 16, 1)
    with torch.inference_mode():
        outs = []
        for m in (fp32, cast):
            feats = m.features(imgs)
            pyr = m.dpt(feats)
            flows, certs = m.flow(pyr, pyr, flow, cert)
            outs.append(feats + pyr + flows + certs)
    for a, b in zip(*outs):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ---- matching modes -------------------------------------------------------------


@pytest.fixture(scope="module")
def match_inputs():
    rng = np.random.default_rng(1)
    B, N, h, C = 2, 8, 16, 64
    tem = rng.normal(size=(N, h, h, C)).astype(np.float32)
    qry = rng.normal(size=(B, h, h, C)).astype(np.float32)
    qry[0] = tem[3] + 0.3 * qry[0]  # query 0 near view 3: a real margin
    mask = (rng.random((B, 224, 224)) > 0.4).astype(np.float32)
    return tem, qry, mask


def test_int8_scores_match_the_pallas_kernel(match_inputs):
    tem, qry, mask = match_inputs
    N, h, _, C = tem.shape
    B, S = qry.shape[0], h * h
    q = jax_l2_normalize(jnp.asarray(qry), axis=-1).reshape(B, S, C)
    qm = jax_resize_nearest(jnp.asarray(mask), (h, h)).reshape(B, S)
    t = jax_l2_normalize(jnp.asarray(tem), axis=-1).reshape(N, S, C)
    qi = jnp.clip(jnp.round(q * 127.0), -127, 127).astype(jnp.int8)
    ti = jnp.clip(jnp.round(t * 127.0), -127, 127).astype(jnp.int8)
    ref = np.asarray(match_scores_pallas(qi, qm, ti, interpret=True))

    tq = M.quantize_int8(torch.tensor(np.asarray(q)))
    tt = M.quantize_int8(torch.tensor(np.asarray(t)))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(qi))
    got = M.match_scores_plain(tq, torch.tensor(np.asarray(qm)), tt)
    assert_close(got.numpy(), ref, atol=1e-6, what="int8 scores")

    # the int8 mode of match_templates quantises the same fp32 operands
    scores, ids = M.match_templates(torch.from_numpy(tem), torch.from_numpy(qry), torch.from_numpy(mask),
                                    topk=N, mode="int8")
    r_scores, r_ids = jax.lax.top_k(ref, N)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(r_ids))
    assert_close(scores.numpy(), np.asarray(r_scores), atol=1e-6, what="int8 top-k scores")
    assert ids[0, 0].item() == 3


def test_fp32_operand_mode_on_a_bf16_bank(match_inputs):
    tem, qry, mask = match_inputs
    N = tem.shape[0]
    tem16 = jnp.asarray(tem, jnp.bfloat16)
    r_scores, r_ids = jax_match_templates(tem16, jnp.asarray(qry), jnp.asarray(mask), topk=5, impl="xla")
    t16 = torch.from_numpy(np.asarray(tem16.astype(jnp.float32))).bfloat16()
    scores, ids = M.match_templates(t16, torch.from_numpy(qry), torch.from_numpy(mask), topk=5, mode="fp32")
    np.testing.assert_array_equal(ids.numpy(), np.asarray(r_ids))
    assert_close(scores.numpy(), np.asarray(r_scores), atol=1e-5, what="fp32-operand scores")
    default, _ = M.match_templates(t16, torch.from_numpy(qry), torch.from_numpy(mask), topk=N, mode=None)
    assert not torch.equal(default[:, :5], scores)  # a bf16 bank rounds its operands by default


def test_modes_are_read_from_the_environment(match_inputs, monkeypatch):
    tem, qry, mask = (torch.from_numpy(a) for a in match_inputs)
    tem16 = tem.bfloat16()
    for var, mode in (("PICOPOSE_MATCH_INT8", "int8"), ("PICOPOSE_MATCH_FP32", "fp32")):
        monkeypatch.setenv(var, "1")
        assert M.match_mode_from_env() == mode
        got = M.match_templates(tem16, qry, mask, topk=8)
        ref = M.match_templates(tem16, qry, mask, topk=8, mode=mode)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
        monkeypatch.delenv(var)
    assert M.match_mode_from_env() is None
    with pytest.raises(ValueError, match="mode"):
        M.match_templates(tem16, qry, mask, mode="int4")


# ---- int8 convolutions ----------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cin,cout,k", [(50, 256, 1), (2, 128, 7), (256, 126, 3), (640, 64, 3)])
def test_quantized_conv_matches_jax(dtype, cin, cout, k):
    rng = np.random.default_rng(cin + k)
    x = (rng.normal(size=(2, 12, 10, cin)) * 2).astype(np.float32)
    kernel = (rng.normal(size=(k, k, cin, cout)) / np.sqrt(k * k * cin)).astype(np.float32)
    bias = (0.1 * rng.normal(size=cout)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    ref = np.asarray(jax_quantized_conv(jnp.asarray(x, jdt), jnp.asarray(kernel), jnp.asarray(bias), k // 2)
                     .astype(jnp.float32))
    tx = torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2)  # NCHW view of NHWC memory
    got = quantized_conv(tx, torch.from_numpy(kernel).permute(3, 2, 0, 1), torch.from_numpy(bias), k // 2)
    assert got.dtype == tdt and got.shape == (2, cout, 12, 10)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).float().numpy(), ref)


# ---- the flow decoder's int8 and unfused paths -------------------------------------


@pytest.fixture(scope="module")
def int8_models():
    jmodel = JaxPicoPose(**SMALL, compute_dtype=jnp.float32, quantize_stage3=True)
    variables = random_flax_variables(jmodel, seed=1)
    tmodel = PicoPose(**SMALL, compute_dtype=torch.float32, device="cpu", quantize_stage3=True)
    load_flax_variables(tmodel, variables)
    return jmodel, variables, tmodel


@pytest.mark.parametrize("level", range(3))
def test_int8_decoder_modules_match_jax(int8_models, level):
    """The motion encoder (corr width 25 (level + 1)) and both XHeads with
    int8 convs on the same inputs as the JAX modules."""
    _, variables, tmodel = int8_models
    fd, dec = variables["params"]["flow_decoder"], tmodel.flow_decoder
    rng = np.random.default_rng(level)
    corr = rng.normal(size=(2, 8, 8, 25 * (level + 1))).astype(np.float32)
    flow = (2 * rng.normal(size=(2, 8, 8, 2))).astype(np.float32)
    x = np.maximum(rng.normal(size=(2, 8, 8, 640)), 0).astype(np.float32)
    ref = [JaxMotionEncoder(quantize=True).apply({"params": fd[f"encoder_{level}"]}, corr, flow),
           JaxXHead(2, "flow", quantize=True).apply({"params": fd[f"flow_pred_{level}"]}, x),
           JaxXHead(1, "mask", quantize=True).apply({"params": fd[f"mask_pred_{level}"]}, x)]
    tx = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.inference_mode():
        got = [dec.encoder[level](torch.from_numpy(corr), torch.from_numpy(flow), True),
               dec.flow_pred[level](tx, True), dec.mask_pred[level](tx, True)]
    for g, r, what in zip(got, ref, ("motion", "flow head", "mask head")):
        assert g.shape == r.shape
        assert _rel_rms(g.numpy(), r) <= 1e-5, (what, _rel_rms(g.numpy(), r))


@pytest.fixture(scope="module")
def flow_inputs():
    """An 8 / 16 / 32-cell pyramid (half the decoder's widths, a quarter of
    the int8 conv work of the JAX package's CPU path), two template streams
    on one query map."""
    rng = np.random.default_rng(4)
    tem = [rng.normal(size=(2, g, g, 256)).astype(np.float32) for g in (8, 16, 32)]
    real = [rng.normal(size=(1, g, g, 256)).astype(np.float32) for g in (8, 16, 32)]
    flow = (rng.normal(size=(2, 8, 8, 2)) * 2).astype(np.float32)
    cert = (rng.random((2, 8, 8, 1)) > 0.3).astype(np.float32)
    return tem, real, flow, cert


def _flows(jmodel, variables, tmodel, inputs):
    tem, real, flow, cert = inputs
    fn = jax.jit(lambda v, *a: jmodel.apply(v, *a, method=jmodel.flow))
    j = lambda xs: [jnp.asarray(x) for x in xs]
    ref = fn(variables, j(tem), j(real), jnp.asarray(flow), jnp.asarray(cert))
    t = lambda xs: [torch.from_numpy(x) for x in xs]
    with torch.inference_mode():
        got = tmodel.flow(t(tem), t(real), torch.from_numpy(flow), torch.from_numpy(cert))
    return [[np.asarray(x) for x in r] for r in ref], [[x.numpy() for x in g] for g in got]


def test_int8_flow_decoder_matches_jax(int8_models, flow_inputs):
    """Level 0 within 1e-3 relative RMS [1.4e-4].  Later levels requantise
    flows that already differ in their last bits, and a value that crosses
    a rounding boundary moves a whole conv output by one int8 step, so the
    two packages drift apart level by level (each module alone agrees to
    1e-5 above): every level within 0.1 [0.034; the int8 path itself moves
    the certainties 0.056 from the float path's]."""
    ref, got = _flows(*int8_models, flow_inputs)
    for level in range(3):
        for kind in range(2):
            err = _rel_rms(got[kind][level], ref[kind][level])
            assert err <= (1e-3 if level == 0 else 0.1), (kind, level, err)


def test_unfused_flow_decoder_matches_jax(flow_inputs):
    jmodel = JaxPicoPose(**SMALL, compute_dtype=jnp.float32, fuse_xheads=False)
    variables = random_flax_variables(jmodel, seed=1)
    tmodel = PicoPose(**SMALL, compute_dtype=torch.float32, device="cpu", fuse_xheads=False)
    load_flax_variables(tmodel, variables)
    ref, got = _flows(jmodel, variables, tmodel, flow_inputs)
    for level in range(3):
        assert_close(got[0][level], ref[0][level], atol=1e-3, rtol=1e-4, what=f"flow {level}")
        assert_close(got[1][level], ref[1][level], atol=1e-3, rtol=1e-4, what=f"cert {level}")
    # the same weights run fused, and quantised: the flows move only there
    tmodel.flow_decoder.fuse_xheads = True
    fused = _flows(jmodel, variables, tmodel, flow_inputs)[1]
    tmodel.flow_decoder.quantize = True
    quant = _flows(jmodel, variables, tmodel, flow_inputs)[1]
    assert _rel_rms(fused[0][2], got[0][2]) < 1e-5
    assert 1e-4 < _rel_rms(quant[0][2], got[0][2]) < 0.1
