"""The port's stage-3 flow decoder against the JAX package's.

``PicoPose.flow`` of the port and ``model.apply(..., method=model.flow)``
of the JAX package run at the same converted weights on the same DPT
pyramids: two template streams sharing one query map (group 2) at the
16^2 / 32^2 / 64^2 levels, 256 channels, and an initial flow whose
windows reach past the map edges.

fp32 (measured max errors in brackets): the convs and the lookup sum in
other orders; flows within 1e-3 + 1e-4 relative [1.2e-5 on ~51],
certainties within 1e-3 + 1e-4 relative [8.0e-6 on ~3].
Other decoders (``num_levels``, config ``radius``): config radii 2, 6 and 8
(lookup radii 1, 3 and 4) at 3 levels and at 1, on pyramids of 8^2 /
16^2 / 32^2 cells (the decoder runs at any size; only its channel widths
are fixed), fp32 within the tolerances above; a level count above the
DPT's 3 raises in both packages.
bf16: the JAX package on the CPU runs its XLA lookup and gather paths,
which round the correlation and the lerps to bf16, while the port
follows the TPU kernels (fp32 windows, rounded once); after three levels
of bf16 convs the relative RMS error is within 3e-2 [flows 9.5e-4,
certainties 8.1e-3].
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import SMALL, assert_close, random_flax_variables

from picopose_tpu.models import PicoPose as JaxPicoPose
from picopose_tpu_torch.models import PicoPose
from picopose_tpu_torch.models.flow import FlowDecoder
from picopose_tpu_torch.utils.weights import load_flax_variables


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(4)
    tem = [rng.normal(size=(2, g, g, 256)).astype(np.float32) for g in (16, 32, 64)]
    real = [rng.normal(size=(1, g, g, 256)).astype(np.float32) for g in (16, 32, 64)]
    flow = (rng.normal(size=(2, 16, 16, 2)) * 2).astype(np.float32)
    flow[:, :, :4, 0] -= 6.0  # windows past the left edge
    cert = (rng.random((2, 16, 16, 1)) > 0.3).astype(np.float32)
    return tem, real, flow, cert


def _run(inputs, jdtype, tdtype):
    tem, real, flow, cert = inputs
    jmodel = JaxPicoPose(**SMALL, compute_dtype=jdtype)
    variables = random_flax_variables(jmodel, seed=1)
    fn = jax.jit(lambda v, *a: jmodel.apply(v, *a, method=jmodel.flow))
    j = lambda xs: [jnp.asarray(x) for x in xs]
    ref = fn(variables, j(tem), j(real), jnp.asarray(flow), jnp.asarray(cert))
    tmodel = PicoPose(**SMALL, compute_dtype=tdtype, device="cpu")
    load_flax_variables(tmodel, variables)
    t = lambda xs: [torch.from_numpy(x) for x in xs]
    with torch.inference_mode():
        got = tmodel.flow(t(tem), t(real), torch.from_numpy(flow), torch.from_numpy(cert))
    return [[np.asarray(x) for x in r] for r in ref], [[x.numpy() for x in g] for g in got]


@pytest.fixture(scope="module")
def fp32_pair(inputs):
    return _run(inputs, jnp.float32, torch.float32)


@pytest.mark.parametrize("level,grid", [(0, 16), (1, 32), (2, 64)])
def test_fp32_flows_and_certainties_match(fp32_pair, level, grid):
    (r_flows, r_certs), (flows, certs) = fp32_pair
    assert flows[level].shape == (2, grid, grid, 2) and certs[level].shape == (2, grid, grid, 1)
    assert flows[level].dtype == np.float32
    assert_close(flows[level], r_flows[level], atol=1e-3, rtol=1e-4, what=f"flow {level}")
    assert_close(certs[level], r_certs[level], atol=1e-3, rtol=1e-4, what=f"cert {level}")


def test_bf16_flows_and_certainties_agree(inputs):
    (r_flows, r_certs), (flows, certs) = _run(inputs, jnp.bfloat16, torch.bfloat16)
    rel = lambda a, b: np.linalg.norm(a - b) / np.linalg.norm(b)
    for level in range(3):
        assert flows[level].dtype == np.float32
        assert rel(flows[level], r_flows[level]) < 3e-2, level
        assert rel(certs[level], r_certs[level]) < 3e-2, level


def test_fp32_stage3_matches():
    """``stage3``: the DPT on both backbone stacks (two template streams,
    one query), then the flow decoder [max error 2.5e-5 on ~27]."""
    rng = np.random.default_rng(5)
    tem = [rng.normal(size=(2, 16, 16, 128)).astype(np.float32) for _ in range(4)]
    real = [rng.normal(size=(1, 16, 16, 128)).astype(np.float32) for _ in range(4)]
    flow = (rng.normal(size=(2, 16, 16, 2)) * 2).astype(np.float32)
    cert = np.ones((2, 16, 16, 1), np.float32)
    jmodel = JaxPicoPose(**SMALL, compute_dtype=jnp.float32)
    variables = random_flax_variables(jmodel, seed=2)
    j = lambda xs: [jnp.asarray(x) for x in xs]
    ref = jax.jit(lambda v, *a: jmodel.apply(v, *a, method=jmodel.stage3))(
        variables, j(tem), j(real), jnp.asarray(flow), jnp.asarray(cert))
    tmodel = PicoPose(**SMALL, compute_dtype=torch.float32, device="cpu")
    load_flax_variables(tmodel, variables)
    t = lambda xs: [torch.from_numpy(x) for x in xs]
    with torch.inference_mode():
        got = tmodel.stage3(t(tem), t(real), torch.from_numpy(flow), torch.from_numpy(cert))
    for g_list, r_list in zip(got, ref):
        for level, (g, r) in enumerate(zip(g_list, r_list)):
            assert_close(g.numpy(), np.asarray(r), atol=1e-3, rtol=1e-4, what=f"stage3 level {level}")


def test_flow_needs_an_integer_group(inputs):
    tem, real, flow, cert = inputs
    model = PicoPose(**SMALL, compute_dtype=torch.float32, device="cpu")
    t = lambda xs: [torch.from_numpy(x) for x in xs]
    with pytest.raises(ValueError, match="multiple"):
        model.flow(t(tem), t([np.concatenate([r, r, r]) for r in real]),
                   torch.from_numpy(flow), torch.from_numpy(cert))


@pytest.fixture(scope="module")
def small_inputs():
    """Pyramids of 8^2 / 16^2 / 32^2 cells, two template streams over one
    query map, windows past the left edge."""
    rng = np.random.default_rng(14)
    tem = [rng.normal(size=(2, g, g, 256)).astype(np.float32) for g in (8, 16, 32)]
    real = [rng.normal(size=(1, g, g, 256)).astype(np.float32) for g in (8, 16, 32)]
    flow = (rng.normal(size=(2, 8, 8, 2)) * 2).astype(np.float32)
    flow[:, :, :2, 0] -= 5.0
    cert = (rng.random((2, 8, 8, 1)) > 0.3).astype(np.float32)
    return tem, real, flow, cert


@pytest.mark.parametrize("num_levels", [3, 1])
@pytest.mark.parametrize("radius", [2, 6, 8])
def test_fp32_decoder_matches_jax_at_any_radius(small_inputs, radius, num_levels):
    tem, real, flow, cert = small_inputs
    kw = dict(compute_dtype=jnp.float32, num_levels=num_levels, radius=radius)
    jmodel = JaxPicoPose(**SMALL, **kw)
    variables = random_flax_variables(jmodel, seed=radius + num_levels)
    j = lambda xs: [jnp.asarray(x) for x in xs]
    ref = jax.jit(lambda v, *a: jmodel.apply(v, *a, method=jmodel.flow))(
        variables, j(tem), j(real), jnp.asarray(flow), jnp.asarray(cert))
    tmodel = PicoPose(**SMALL, compute_dtype=torch.float32, device="cpu", num_levels=num_levels, radius=radius)
    load_flax_variables(tmodel, variables)
    n = (2 * (radius // 2) + 1) ** 2
    assert [e.corr_net_0.in_channels for e in tmodel.flow_decoder.encoder] == [n * (l + 1) for l in range(num_levels)]
    t = lambda xs: [torch.from_numpy(x) for x in xs]
    with torch.inference_mode():
        got = tmodel.flow(t(tem), t(real), torch.from_numpy(flow), torch.from_numpy(cert))
    assert len(got[0]) == len(ref[0]) == num_levels
    for level in range(num_levels):
        for g, r, what in ((got[0][level], ref[0][level], "flow"), (got[1][level], ref[1][level], "cert")):
            assert g.shape == r.shape == (2, 8 << level, 8 << level, 2 if what == "flow" else 1)
            assert_close(g.numpy(), np.asarray(r), atol=1e-3, rtol=1e-4, what=f"{what} {level}, radius {radius}")


def test_more_levels_than_the_dpt_gives_raise_in_both_packages(small_inputs):
    with pytest.raises(IndexError):
        random_flax_variables(JaxPicoPose(**SMALL, compute_dtype=jnp.float32, num_levels=4))
    with pytest.raises(ValueError, match="DPT head"):
        PicoPose(**SMALL, compute_dtype=torch.float32, device="cpu", num_levels=4)
    tem, real, flow, cert = small_inputs
    decoder = FlowDecoder(num_levels=4, radius=2)
    t = lambda xs: [torch.from_numpy(x) for x in xs]
    with pytest.raises(ValueError, match="4 levels"):
        decoder(t(tem), t(real), torch.from_numpy(flow), torch.from_numpy(cert))
