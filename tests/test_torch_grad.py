"""Gradients through the port's kernel wrappers against the JAX package.

The JAX package differentiates its Pallas kernels through ``custom_vjp``s
whose backward is ``jax.vjp`` of the XLA form; on the CPU its dispatchers
take the XLA forms themselves.  The port's wrappers (``layernorm``,
``attention``, ``corr_lookup``, ``warp_by_flow``) are autograd Functions
whose backward recomputes the port's copy of that form (ops/vjp.py).  Here
the same inputs and cotangent, drawn from a numpy seed, go through
``jax.vjp`` of ``layernorm_xla``, ``attention_xla``, ``_corr_lookup_xla``
and ``_warp_by_flow_xla`` and through ``torch.autograd.grad`` of the port's
wrapper; then the slice as a whole (``vit_tiny_test`` features, one pass of
the flow decoder) against ``jax.grad`` of the JAX model at the same
variables.

Tolerances (measured largest errors in brackets):
* fp32: the sums run in other orders, atol 1e-5 + rtol 1e-5 [3.8e-6 on
  flow gradients of ~25];
* bf16: both sides round at the same points in the forward (the port's
  ``*_reference`` forms equal the XLA forms up to one bf16 step where an
  fp32 sum before a rounding differs in its last bits), but the
  backward's bf16 sums run in other orders, so each gradient is held
  within 2^-5 of its largest magnitude [1.1% for the warp's flow
  gradient, 0.3% for the lookup's, 0.5% for attention];
* the model: fp32 through four ViT blocks, rtol 1e-4 with atol 1e-4 of
  the gradient's largest magnitude; through the flow decoder, relative RMS
  3e-3 [init flow 1.8e-4, finest template map 1.0e-3]: both sides' flows
  differ by ~1e-5 after a level, and where a sample point lies that close
  to a cell edge the two take the bilinear derivative from neighbouring
  cells, so a few entries move by up to 4e-4 of the largest.  The port's
  Functions and its plain versions differentiated natively agree to 1e-6
  relative RMS on the same inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import SMALL, assert_close, random_flax_variables

from picopose_tpu.models import PicoPose as JaxPicoPose
from picopose_tpu.ops.attention import attention_xla
from picopose_tpu.ops.corr import _corr_lookup_xla
from picopose_tpu.ops.layernorm import layernorm_xla
from picopose_tpu.ops.sample import _warp_by_flow_xla
from picopose_tpu_torch.device import full_fp32
from picopose_tpu_torch.models import PicoPose
from picopose_tpu_torch.ops import attention as A
from picopose_tpu_torch.ops import corr as CO
from picopose_tpu_torch.ops import layernorm as L
from picopose_tpu_torch.ops import sample as S
from picopose_tpu_torch.utils.weights import load_flax_variables

DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
BF16_SHARE = 2**-5


def _assert_grad_close(got, ref, dtype, what):
    got = got.float().numpy()
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    assert got.shape == ref.shape, what
    assert np.abs(ref).max() > 0, what
    if dtype == "fp32":
        assert_close(got, ref, atol=1e-5, rtol=1e-5, what=what)
    else:
        err = np.abs(got - ref).max()
        assert err <= BF16_SHARE * np.abs(ref).max(), (what, err, np.abs(ref).max())


def _vjp_parity(jfn, tfn, inputs, dtype, seed, backward_node):
    """``inputs``: (fp32 numpy array, cast to the working dtype?) pairs.
    jax.vjp of ``jfn`` against torch.autograd.grad of ``tfn`` on the same
    values with the same cotangent; every input's gradient compared."""
    jdt, tdt = DTYPES[dtype]
    j_in = [jnp.asarray(a, jdt if cast else jnp.float32) for a, cast in inputs]
    out, vjp = jax.vjp(jfn, *j_in)
    g = jnp.asarray(np.random.default_rng(seed).normal(size=out.shape).astype(np.float32), out.dtype)
    refs = vjp(g)
    t_in = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt if cast else torch.float32).requires_grad_()
            for a, (_, cast) in zip(j_in, inputs)]
    t_out = tfn(*t_in)
    assert type(t_out.grad_fn).__name__ == backward_node
    assert t_out.dtype == tdt
    grads = torch.autograd.grad(t_out, t_in, torch.from_numpy(np.array(g.astype(jnp.float32))).to(tdt))
    for i, (got, ref) in enumerate(zip(grads, refs)):
        _assert_grad_close(got, ref, dtype, f"input {i}")


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_layernorm_grad_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 7, 64)) * 3 + 1).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=64)).astype(np.float32)
    bias = (0.1 * rng.normal(size=64)).astype(np.float32)
    _vjp_parity(layernorm_xla, L.layernorm, [(x, True), (scale, False), (bias, False)], dtype, 1,
                "_LayerNormBackward")


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("D", [32, 64])
def test_attention_grad_matches_jax(dtype, D):
    rng = np.random.default_rng(D)
    q, k, v = ((rng.normal(size=(2, 3, 17, D))).astype(np.float32) for _ in range(3))
    _vjp_parity(attention_xla, A.attention, [(q, True), (k, True), (v, True)], dtype, 2, "_AttentionBackward")


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_attention_grad_on_qkv_views(dtype):
    """q, k, v as the ViT hands them: (B, H, N, D) views of one (B, N, 3,
    H, D) projection; the gradient lands on the projection."""
    jdt, tdt = DTYPES[dtype]
    qkv = np.random.default_rng(3).normal(size=(2, 17, 3, 4, 32)).astype(np.float32)
    jq = jnp.asarray(qkv, jdt)
    views = lambda t: [t[:, :, i].swapaxes(1, 2) for i in range(3)]
    out, vjp = jax.vjp(lambda a: attention_xla(*views(a)), jq)
    g = jnp.asarray(np.random.default_rng(4).normal(size=out.shape).astype(np.float32), out.dtype)
    (ref,) = vjp(g)
    tq = torch.from_numpy(np.array(jq.astype(jnp.float32))).to(tdt).requires_grad_()
    t_out = A.attention(*[tq[:, :, i].transpose(1, 2) for i in range(3)])
    (got,) = torch.autograd.grad(t_out, tq, torch.from_numpy(np.array(g.astype(jnp.float32))).to(tdt))
    _assert_grad_close(got, ref, dtype, "qkv")


def _flow(rng, B, G, far):
    """A flow whose windows reach past every edge, a few far off the map."""
    flow = (rng.normal(size=(B, G, G, 2)) * 3).astype(np.float32)
    flow[:, ::5] += rng.choice([-1.0, 1.0], size=(B, 1, G, 2)) * G * 0.7
    flow[:, 2, :2] = far
    return flow


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("group", [1, 3])
def test_warp_by_flow_grad_matches_jax(dtype, group):
    rng = np.random.default_rng(10 + group)
    G = 16
    feat = rng.normal(size=(2, G, G, 32)).astype(np.float32)
    flow = _flow(rng, 2 * group, G, -1e4)
    _vjp_parity(lambda a, b: _warp_by_flow_xla(a, b, group), lambda a, b: S.warp_by_flow(a, b, group),
                [(feat, True), (flow, False)], dtype, 5, "_WarpByFlowBackward")


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("group", [1, 3])
def test_corr_lookup_grad_matches_jax(dtype, group):
    """Three pyramid levels (the pooling inside the differentiated form)."""
    rng = np.random.default_rng(20 + group)
    G, C = 16, 64
    f1 = rng.normal(size=(2 * group, G, G, C)).astype(np.float32)
    f2 = rng.normal(size=(2, G, G, C)).astype(np.float32)
    flow = _flow(rng, 2 * group, G, 1e4)
    _vjp_parity(lambda a, b, c: _corr_lookup_xla(a, b, c, 2, 3, group),
                lambda a, b, c: CO.corr_lookup(a, b, c, 2, 3, group),
                [(f1, True), (f2, True), (flow, False)], dtype, 6, "_CorrLookupBackward")


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_references_are_the_xla_forms(dtype):
    """The recomputed forms equal the JAX package's XLA forms in the forward
    (bf16: up to one bf16 step, of the output or of an intermediate that an
    fp32 sum rounds on each side, [1 of 115,200 values]; fp32: up to
    summation order),
    where the kernels' plain versions round elsewhere."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(30)
    t = lambda a, cast=True: torch.from_numpy(np.array(jnp.asarray(a, jdt if cast else jnp.float32)
                                                        .astype(jnp.float32))).to(tdt if cast else torch.float32)
    # bf16: one step of the output, or of an intermediate of up to ~1/4
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "fp32" else dict(atol=2**-10, rtol=2**-7)
    feat, flow = rng.normal(size=(2, 16, 16, 32)).astype(np.float32), _flow(rng, 6, 16, 1e4)
    f1 = rng.normal(size=(6, 16, 16, 64)).astype(np.float32)
    f2 = rng.normal(size=(2, 16, 16, 64)).astype(np.float32)
    x = (rng.normal(size=(3, 64)) * 3).astype(np.float32)
    q = rng.normal(size=(1, 2, 9, 32)).astype(np.float32)
    pairs = [
        (S.warp_by_flow_reference(t(feat), t(flow, False), 3), _warp_by_flow_xla(jnp.asarray(feat, jdt), flow, 3)),
        (CO.corr_lookup_reference(t(f1), t(f2), t(flow, False), 2, 3, 3),
         _corr_lookup_xla(jnp.asarray(f1, jdt), jnp.asarray(f2, jdt), flow, 2, 3, 3)),
        (L.layernorm_reference(t(x), torch.ones(64), torch.zeros(64)),
         layernorm_xla(jnp.asarray(x, jdt), jnp.ones(64), jnp.zeros(64))),
        (A.attention_reference(t(q), t(q), t(q)), attention_xla(*[jnp.asarray(q, jdt)] * 3)),
    ]
    for i, (got, ref) in enumerate(pairs):
        assert got.dtype == tdt
        assert_close(got.float().numpy(), np.asarray(ref.astype(jnp.float32)), what=f"form {i}", **tol)


def test_wrappers_enter_the_function_only_for_gradients():
    """Without grad mode or an input that requires grad, the wrappers call
    the forward directly: no autograd node, the inference path unchanged."""
    x, w, b = torch.randn(2, 3, 8), torch.ones(8), torch.zeros(8)
    assert L.layernorm(x, w, b).grad_fn is None
    w.requires_grad_()
    assert type(L.layernorm(x, w, b).grad_fn).__name__ == "_LayerNormBackward"
    with torch.no_grad():
        assert L.layernorm(x, w, b).grad_fn is None
    with torch.inference_mode():
        assert L.layernorm(x, w, b).grad_fn is None
    torch.testing.assert_close(L.layernorm(x, w, b).detach(), L.layernorm_plain(x, w, b), atol=0, rtol=0)


def _node_names(t: torch.Tensor) -> set:
    seen, todo, names = set(), [t.grad_fn], set()
    while todo:
        n = todo.pop()
        if n is None or n in seen:
            continue
        seen.add(n)
        names.add(type(n).__name__)
        todo.extend(f for f, _ in n.next_functions)
    return names


def _model_tol(ref):
    return dict(atol=1e-4 * float(np.abs(ref).max()), rtol=1e-4)


def test_features_grad_matches_jax():
    """∂loss/∂images through ``features`` (vit_tiny_test, four blocks, fp32)
    and the gradient of block 0's LN scale and qkv weight, carried across
    by utils/weights.py, against jax.grad of the JAX model."""
    jmodel = JaxPicoPose(**SMALL, compute_dtype=jnp.float32)
    variables = random_flax_variables(jmodel, seed=3)
    rng = np.random.default_rng(7)
    images = rng.normal(size=(2, 224, 224, 3)).astype(np.float32)
    proj = [rng.normal(size=(2, 16, 16, 128)).astype(np.float32) for _ in range(4)]

    def jloss(v, x):
        taps = jmodel.apply(v, x, method=jmodel.features)
        return sum(jnp.sum(t * p) for t, p in zip(taps, proj))

    gv, gx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(variables, jnp.asarray(images))
    blk = gv["params"]["feature_extractor"]["dinov2"]["blocks_0"]

    model = PicoPose(**SMALL, compute_dtype=torch.float32, device="cpu")
    load_flax_variables(model, variables)
    x = torch.from_numpy(images).requires_grad_()
    taps = model.features(x)
    loss = sum((t * torch.from_numpy(p)).sum() for t, p in zip(taps, proj))
    assert {"_LayerNormBackward", "_AttentionBackward"} <= _node_names(loss)
    loss.backward()
    tblk = model.feature_extractor.dinov2.blocks[0]
    for what, got, ref in (
        ("images", x.grad.numpy(), np.asarray(gx)),
        ("block 0 norm1 scale", tblk.norm1.weight.grad.numpy(), np.asarray(blk["norm1"]["scale"])),
        ("block 0 qkv weight", tblk.attn.qkv.weight.grad.numpy(), np.asarray(blk["attn"]["qkv"]["kernel"]).T),
    ):
        assert np.abs(ref).max() > 0, what
        assert_close(got, ref, what=what, **_model_tol(ref))


def test_flow_decoder_grad_matches_jax():
    """∂loss/∂(init flow, both pyramids) through one flow-decoder pass
    (8^2 / 16^2 / 32^2 levels, two template streams sharing one query map,
    fp32) against jax.grad of the JAX model's ``flow``."""
    jmodel = JaxPicoPose(**SMALL, compute_dtype=jnp.float32)
    variables = random_flax_variables(jmodel, seed=4)
    rng = np.random.default_rng(8)
    tem = [rng.normal(size=(2, g, g, 256)).astype(np.float32) for g in (8, 16, 32)]
    real = [rng.normal(size=(1, g, g, 256)).astype(np.float32) for g in (8, 16, 32)]
    flow = (rng.normal(size=(2, 8, 8, 2)) * 2).astype(np.float32)
    flow[:, :, :2, 0] -= 5.0  # windows past the left edge
    cert = (rng.random((2, 8, 8, 1)) > 0.3).astype(np.float32)
    pf = [rng.normal(size=(2, g, g, 2)).astype(np.float32) for g in (8, 16, 32)]
    pc = [rng.normal(size=(2, g, g, 1)).astype(np.float32) for g in (8, 16, 32)]

    def jloss(tem, real, flow):
        flows, certs = jmodel.apply(variables, tem, real, flow, jnp.asarray(cert), method=jmodel.flow)
        return sum(jnp.sum(f * p) for f, p in zip(flows, pf)) + sum(jnp.sum(c * p) for c, p in zip(certs, pc))

    j = lambda xs: [jnp.asarray(a) for a in xs]
    g_tem, g_real, g_flow = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(j(tem), j(real), jnp.asarray(flow))

    model = PicoPose(**SMALL, compute_dtype=torch.float32, device="cpu")
    load_flax_variables(model, variables)
    t = lambda xs: [torch.from_numpy(a).requires_grad_() for a in xs]
    t_tem, t_real, t_flow = t(tem), t(real), torch.from_numpy(flow).requires_grad_()
    flows, certs = model.flow(t_tem, t_real, t_flow, torch.from_numpy(cert))
    loss = sum((f * torch.from_numpy(p)).sum() for f, p in zip(flows, pf)) \
        + sum((c * torch.from_numpy(p)).sum() for c, p in zip(certs, pc))
    assert {"_CorrLookupBackward", "_WarpByFlowBackward"} <= _node_names(loss)
    loss.backward()
    pairs = [("init flow", t_flow, g_flow)] + [(f"tem {i}", a, b) for i, (a, b) in enumerate(zip(t_tem, g_tem))] \
        + [(f"real {i}", a, b) for i, (a, b) in enumerate(zip(t_real, g_real))]
    for what, got, ref in pairs:
        ref = np.asarray(ref, np.float64)
        rel = np.linalg.norm(got.grad.numpy() - ref) / np.linalg.norm(ref)
        assert np.abs(ref).max() > 0 and rel <= 3e-3, (what, rel)


def test_full_fp32_restores_the_flags():
    """Both TF32 flags are off inside and the caller's values come back
    after a normal exit, after a raise, and around a decorated call."""
    flags = lambda: (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    before = flags()
    try:
        for caller in ((True, True), (True, False), (False, True)):
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = caller
            with full_fp32():
                assert flags() == (False, False)
            assert flags() == caller
            with pytest.raises(KeyError):
                with full_fp32():
                    raise KeyError("inside")
            assert flags() == caller

            @full_fp32()
            def inside():
                return flags()

            assert inside() == (False, False) and flags() == caller
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before
