"""The port's scoring (eval/metrics.py, eval/bop_scoring.py, score_csv)
against the JAX package's, on the CPU.

Every case of tests/test_bop_scoring.py, tests/test_metrics.py and the
scoring cases of tests/test_synthetic_world.py runs through both packages
on the same seeded inputs, and the results are equal: the port's modules
are copies of the JAX ones on numpy and scipy, with the same generators
and seeds.  ``python -m picopose_tpu_torch.score_csv`` prints the JSON the
JAX ``score_csv.py`` prints, on a small rendered BOP tree (two cube
models, one with discrete and one with continuous symmetries, three
images, 16-bit scene depth PNGs, a GT instance below the visibility
threshold), plain and with ``--vsd``, ``--bootstrap``, ``--dump_records``
and ``--paired_vs`` (records dumped by either package).  No tolerance:
every comparison is exact.
"""

import importlib.util
import json
import os
import pickle
import sys

import numpy as np
import pytest
from PIL import Image
from scipy.spatial.transform import Rotation
from test_native import make_cube_ply

from picopose_tpu.eval import bop_scoring as JB
from picopose_tpu.eval import metrics as JM
from picopose_tpu.native import renderer as JR
from picopose_tpu_torch import score_csv
from picopose_tpu_torch.eval import bop_scoring as TB
from picopose_tpu_torch.eval import metrics as TM
from picopose_tpu_torch.eval.bop_csv import format_row

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = np.array([[572.4114, 0, 320.0], [0, 573.57043, 240.0], [0, 0, 1.0]])


def _equal(a, b, path="result"):
    """Exact equality of nested results (dicts, lists, tuples, arrays,
    floats, dataclasses' fields)."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and a.keys() == b.keys(), path
        for k in b:
            _equal(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(b, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}[{i}]")
    elif isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif b is None or isinstance(b, (bool, int, float, str, np.generic)):
        assert type(a) is type(b) and (a == b or (a != a and b != b)), f"{path}: {a!r} != {b!r}"
    else:
        _equal(vars(a), vars(b), path)


def make_model(m, rng, n=200, scale=40.0):
    pts = rng.uniform(-scale, scale, size=(n, 3))
    d = np.linalg.norm(pts[:, None] - pts[None], axis=-1).max()
    return m.ObjectModel(pts=pts, diameter=float(d))


# ---- metrics.py (tests/test_metrics.py) -------------------------------------


def metrics_case(m, rng):
    R = Rotation.from_euler("z", 30, degrees=True).as_matrix()
    out = {"rot": m.rotation_error_deg(R, np.eye(3)), "rot0": m.rotation_error_deg(np.eye(3), np.eye(3))}
    pts = rng.normal(size=(100, 3))
    R1 = Rotation.random(random_state=1).as_matrix()
    t = np.array([0.1, -0.2, 0.5])
    out["add0"], out["adds0"] = m.add_metric(R1, t, R1, t, pts), m.adds_metric(R1, t, R1, t, pts)
    theta = np.linspace(0, 2 * np.pi, 200, endpoint=False)
    ring = np.stack([np.cos(theta), np.sin(theta), np.zeros_like(theta)], -1)
    Rz = Rotation.from_euler("z", 45, degrees=True).as_matrix()
    out["add_ring"] = m.add_metric(Rz, np.zeros(3), np.eye(3), np.zeros(3), ring)
    out["adds_ring"] = m.adds_metric(Rz, np.zeros(3), np.eye(3), np.zeros(3), ring)
    Rb = Rotation.random(4, random_state=2).as_matrix()
    tb = rng.normal(size=(4, 3))
    out["adds_batch"] = m.adds_metric(Rb, tb, Rb, tb + 0.01, pts[:50])
    out["translation"] = m.translation_error(tb, tb + 0.01)
    out["summary"] = m.pose_summary(Rb, tb, Rb[::-1], tb + 0.01, model_points=pts[:50], diameter=1.0)
    out["summary_no_model"] = m.pose_summary(Rb, tb, Rb, tb)
    return out


# ---- bop_scoring.py (tests/test_bop_scoring.py, test_synthetic_world.py) ----


def mssd_mspd_case(m, rng):
    mod = make_model(m, rng)
    out = []
    sym_sets = [
        m.identity_syms(), m.continuous_syms(np.array([0.0, 0.0, 1.0]), n=12),
        m.discrete_syms([np.diag([-1.0, -1.0, 1.0, 1.0]).reshape(-1).tolist(), {"matrix": np.eye(4).tolist()}, {}]),
    ]
    for syms in sym_sets:
        for trial in range(4):
            R_e = Rotation.random(random_state=trial).as_matrix()
            R_g = Rotation.random(random_state=100 + trial).as_matrix()
            t_e = rng.uniform(-20, 20, 3) + [0, 0, 600]
            t_g = rng.uniform(-20, 20, 3) + [0, 0, 600]
            out.append((m.mssd(R_e, t_e, R_g, t_g, mod.pts, syms), m.mspd(R_e, t_e, R_g, t_g, K, mod.pts, syms)))
    theta = np.linspace(0, 2 * np.pi, 72, endpoint=False)
    ring = np.stack([30 * np.cos(theta), 30 * np.sin(theta), np.zeros_like(theta)], -1)
    Rz = Rotation.from_euler("z", 40, degrees=True).as_matrix()
    t = np.array([0.0, 0.0, 500.0])
    out.append(m.mssd(Rz, t, np.eye(3), t, ring, m.continuous_syms([0, 0, 1], 72)))
    return {"errors": out, "syms": sym_sets}


def vsd_case(m, rng):
    H = W = 24
    d_est = np.where(rng.random((H, W)) > 0.4, rng.uniform(400, 600, (H, W)), 0.0)
    d_gt = np.where(rng.random((H, W)) > 0.4, rng.uniform(400, 600, (H, W)), 0.0)
    d_scene = np.where(rng.random((H, W)) > 0.3, rng.uniform(350, 650, (H, W)), 0.0)
    taus = np.array([5.0, 20.0, 80.0])
    a = np.zeros((40, 40)); a[:20] = 450.0
    b = np.zeros((40, 40)); b[20:] = 450.0
    return {
        "occluded": m.vsd(d_est, d_gt, d_scene, taus, 15.0),
        "free": m.vsd(d_est, d_gt, None, taus, 15.0),
        "disjoint": m.vsd(a, b, None, np.array([100.0])),
        "empty": m.vsd(np.zeros((4, 4)), np.zeros((4, 4)), None, taus),
    }


def _world(m, rng, n=24):
    mod = make_model(m, rng)
    gts, Ks = [], {}
    for i in range(n):
        R = Rotation.random(random_state=i).as_matrix()
        gts.append(m.GTInstance(1, i, 7, R, np.array([0.0, 0.0, 500.0 + 5 * i])))
        Ks[(1, i)] = K
    return mod, gts, Ks


def score_case(m, rng):
    """Perfect, bad, missed and duplicate estimates, per-instance records,
    the bootstrap and the paired bootstrap (tests/test_bop_scoring.py's
    TestScoring and TestPairedDelta)."""
    mod, gts, Ks = _world(m, rng, n=40)
    ests_a, ests_b = [], []
    for i, g in enumerate(gts):
        off = np.array([0.02 * mod.diameter * (i % 5), 0.0, 0.0])
        extra = np.array([0.1 * mod.diameter, 0, 0]) if i < 4 else 0.0
        if i % 9 != 8:  # every ninth instance missed
            ests_a.append(m.Estimate(g.scene_id, g.im_id, g.obj_id, 0.9, g.R, g.t + off))
        ests_b.append(m.Estimate(g.scene_id, g.im_id, g.obj_id, 0.9, g.R, g.t + off + extra))
        if i % 7 == 0:  # a lower-scored duplicate far off
            ests_b.append(m.Estimate(g.scene_id, g.im_id, g.obj_id, 0.5, g.R.T, g.t + 200.0))
    gts[3] = m.GTInstance(1, 3, 7, gts[3].R, gts[3].t, visib_fract=0.05)  # below visib_gt_min
    ra, rb = [], []
    out = {
        "a": m.score_bop19(ests_a, gts, {7: mod}, Ks, per_instance=ra),
        "b": m.score_bop19(ests_b, gts, {7: mod}, Ks, per_instance=rb, im_width=1280),
        "records": ra,
        "boot": m.bootstrap_ar(ra, n_boot=300, seed=4),
        "paired": m.paired_delta_ar(ra, rb, n_boot=300, seed=2),
        "paired_default": m.paired_delta_ar(rb, ra),
        "boot_empty": m.bootstrap_ar([]),
    }
    try:
        m.paired_delta_ar(ra, rb[:-1])
    except ValueError as e:
        out["mismatch"] = str(e)
    return out


def symmetry_case(m, rng):
    """tests/test_synthetic_world.py::TestSymmetryScoring."""
    from tools.synthetic_world import cube_rotations

    pts = rng.uniform(-30, 30, (200, 3))
    syms = np.stack([np.eye(4)] + cube_rotations())
    R_gt = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    if np.linalg.det(R_gt) < 0:
        R_gt[:, 0] *= -1
    t = np.array([0, 0, 240.0])
    R_est = R_gt @ cube_rotations()[7][:3, :3]
    Kk = {(1, 0): np.array([[572.0, 0, 320], [0, 573.0, 240], [0, 0, 1.0]])}
    gt = [m.GTInstance(1, 0, 3, R_gt, t)]
    est = [m.Estimate(1, 0, 3, 0.9, R_est, t)]
    recs = [{"mssd": rng.random(len(m.MSSD_THRESHOLDS)) < 0.7, "mspd": rng.random(len(m.MSPD_THRESHOLDS)) < 0.8,
             "vsd": rng.random((10, 10)) < 0.5} for _ in range(200)]
    return {
        "with": m.score_bop19(est, gt, {3: m.ObjectModel(pts=pts, diameter=60.0, syms=syms)}, Kk),
        "without": m.score_bop19(est, gt, {3: m.ObjectModel(pts=pts, diameter=60.0)}, Kk),
        "boot": m.bootstrap_ar(recs, n_boot=500, seed=0),
    }


def rendered_vsd_case(m, rng):
    """Perfect and offset estimates with depth from the renderer of the
    same package (tests/test_bop_scoring.py::test_full_bop19_with_rendered_vsd)."""
    import tempfile

    renderer = JR if m is JB else __import__("picopose_tpu_torch.native.renderer", fromlist=["_"])
    with tempfile.TemporaryDirectory() as d:
        cad = os.path.join(d, "c.ply")
        make_cube_ply(cad, size=60.0)
        verts, colors, faces = renderer.load_ply(cad)

    def render_depth(obj_id, R, t, Kk):
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3], pose[:3, 3] = R, t
        _, depth = renderer.render_views(verts, colors, faces, pose[None], Kk.astype(np.float32), (480, 640),
                                         n_threads=2)
        return depth[0].astype(np.float64)

    diam = float(np.linalg.norm(verts[:, None] - verts[None], axis=-1).max())
    mod = m.ObjectModel(pts=verts.astype(np.float64), diameter=diam)
    gts, ests, recs = [], [], []
    for i in range(3):
        R = Rotation.random(random_state=2 + i).as_matrix()
        t = np.array([5.0, -3.0, 450.0 + 20 * i])
        gts.append(m.GTInstance(1, i, 7, R, t))
        ests.append(m.Estimate(1, i, 7, 0.9, R, t + [0.0, 0.0, 8.0 * i]))
    scene = {(1, 1): render_depth(7, gts[1].R, gts[1].t - [0, 0, 30.0], K)}
    out = m.score_bop19(ests, gts, {7: mod}, {(1, i): K for i in range(3)}, render_depth=render_depth,
                        scene_depth_by_image=scene, per_instance=recs)
    return {"scores": out, "records": recs, "boot": m.bootstrap_ar(recs, n_boot=200)}


def csv_case(m, rng, tmp_path):
    rows = []
    for i in range(4):
        R = Rotation.random(random_state=5 + i).as_matrix()
        rows.append(format_row(3, 14 + i, 7, 0.8 - 0.1 * i, R, rng.normal(size=3) * 0.1, 0.1))
    p = tmp_path / f"{m.__name__}.csv"
    p.write_text("scene_id,im_id,obj_id,score,R,t,time\n" + "".join(rows) + "\n")
    return m.read_csv(str(p))


CASES = {
    "metrics": metrics_case, "mssd_mspd": mssd_mspd_case, "vsd": vsd_case, "score": score_case,
    "symmetry": symmetry_case, "rendered_vsd": rendered_vsd_case,
}


@pytest.mark.parametrize("case", list(CASES))
def test_scoring_equals_the_jax_modules(case):
    port, jax = (TM, JM) if case == "metrics" else (TB, JB)
    _equal(CASES[case](port, np.random.default_rng(0)), CASES[case](jax, np.random.default_rng(0)))


def test_read_csv_equals_the_jax_one(tmp_path):
    _equal(csv_case(TB, np.random.default_rng(1), tmp_path), csv_case(JB, np.random.default_rng(1), tmp_path))


def test_constants_are_the_jax_ones():
    for name in ("MSSD_THRESHOLDS", "MSPD_THRESHOLDS", "VSD_TAUS", "VSD_THETAS"):
        _equal(getattr(TB, name), getattr(JB, name), name)
    _equal(TB.identity_syms(), JB.identity_syms())


def test_the_expected_outcomes_hold():
    """The outcomes tests/test_bop_scoring.py asserts of the JAX module
    hold for the port's."""
    s = symmetry_case(TB, np.random.default_rng(0))
    assert s["with"]["AR_mssd_mspd"] == 1.0 and s["without"]["AR_mssd_mspd"] == 0.0
    r = rendered_vsd_case(TB, np.random.default_rng(0))["scores"]
    assert 0.0 < r["AR_VSD"] < 1.0 and r["AR_MSSD"] > 0.5
    sc = score_case(TB, np.random.default_rng(0))
    assert sc["a"]["n_gt"] == 39 and "record sets differ" in sc["mismatch"]
    d = TB.paired_delta_ar(sc["records"], sc["records"])
    assert all(v["delta"] == 0.0 and v["ci95"] == [0.0, 0.0] for v in d.values())


# ---- score_csv ----------------------------------------------------------------


DATASET = "fakeds"
OBJ_SIZES = {1: 60.0, 2: 40.0}


def _pose(seed, z):
    R = Rotation.random(random_state=seed).as_matrix()
    return R, np.array([10.0 * (seed % 3 - 1), -8.0 * (seed % 2), z])


@pytest.fixture(scope="module")
def bop_tree(tmp_path_factory):
    """A BOP tree of two cube models and three images with 16-bit scene
    depth (image 2 has none), and two bop19 CSVs of perturbed estimates."""
    root = tmp_path_factory.mktemp("score")
    base = root / DATASET
    (base / "models").mkdir(parents=True)
    info = {}
    meshes = {}
    for obj, size in OBJ_SIZES.items():
        path = str(base / "models" / f"obj_{obj:06d}.ply")
        make_cube_ply(path, size=size, binary=obj == 2)
        meshes[obj] = JR.load_ply(path)
        v = meshes[obj][0]
        info[str(obj)] = {"diameter": float(np.linalg.norm(v[:, None] - v[None], axis=-1).max())}
    info["1"]["symmetries_discrete"] = [np.diag([-1.0, -1.0, 1.0, 1.0]).reshape(-1).tolist()]
    info["2"]["symmetries_continuous"] = [{"axis": [0, 0, 1], "offset": [0, 0, 0]}]
    (base / "models" / "models_info.json").write_text(json.dumps(info))

    sdir = base / "test" / "000001"
    (sdir / "depth").mkdir(parents=True)
    layout = {0: [(1, 0, 420.0), (2, 1, 520.0)], 1: [(1, 2, 460.0), (1, 3, 700.0), (2, 4, 480.0)], 2: [(2, 5, 500.0)]}
    scene_gt, cams, gt_info = {}, {}, {}
    rows_a, rows_b = [], []
    rng = np.random.default_rng(0)
    for im, objs in layout.items():
        scale = 0.1 if im == 1 else 1.0
        cams[str(im)] = {"cam_K": K.reshape(-1).tolist(), "depth_scale": scale}
        scene_gt[str(im)], gt_info[str(im)] = [], []
        depth = np.zeros((480, 640))
        for k, (obj, seed, z) in enumerate(objs):
            R, t = _pose(seed, z)
            scene_gt[str(im)].append({"obj_id": obj, "cam_R_m2c": R.reshape(-1).tolist(), "cam_t_m2c": t.tolist()})
            gt_info[str(im)].append({"visib_fract": 0.05 if (im, k) == (1, 1) else 0.9})
            pose = np.eye(4, dtype=np.float32)
            pose[:3, :3], pose[:3, 3] = R, t
            d = JR.render_views(*meshes[obj], pose[None], K.astype(np.float32), (480, 640), n_threads=2)[1][0]
            depth = np.where((d > 0) & ((depth == 0) | (d < depth)), d, depth)
            for rows, spread in ((rows_a, 1.0), (rows_b, 3.0)):
                dR = Rotation.from_rotvec(rng.normal(size=3) * 0.03 * spread).as_matrix()
                dt = rng.normal(size=3) * 2.0 * spread
                rows.append(format_row(1, im, obj, float(rng.uniform(0.3, 1.0)), dR @ R, (t + dt) / 1000.0, 0.5))
        if im != 2:
            Image.fromarray(np.round(depth / scale).astype(np.uint16)).save(sdir / "depth" / f"{im:06d}.png")
    rows_b.append(format_row(1, 0, 1, 0.2, np.eye(3), np.array([0.0, 0.0, 0.3]), 0.5))  # an extra estimate
    for name, data in (("scene_gt", scene_gt), ("scene_camera", cams), ("scene_gt_info", gt_info)):
        (sdir / f"{name}.json").write_text(json.dumps(data))
    header = "scene_id,im_id,obj_id,score,R,t,time\n"
    (root / "a.csv").write_text(header + "".join(rows_a[:2] + rows_a[3:]))  # an instance missed
    (root / "b.csv").write_text(header + "".join(rows_b))
    return root


def _jax_score_csv():
    spec = importlib.util.spec_from_file_location("jax_score_csv", os.path.join(ROOT, "score_csv.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_both(capsys, monkeypatch, args):
    """(port JSON, JAX JSON) of one command line."""
    capsys.readouterr()
    got = score_csv.main(args)
    printed = json.loads(capsys.readouterr().out)
    assert printed == json.loads(json.dumps(got))
    monkeypatch.setattr(sys, "argv", ["score_csv.py", *args])
    _jax_score_csv().main()
    return printed, json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("flags", [[], ["--vsd"], ["--bootstrap", "50"], ["--vsd", "--bootstrap", "40"],
                                   ["--n_model_pts", "5"]])
def test_score_csv_prints_the_jax_json(bop_tree, capsys, monkeypatch, flags):
    base = ["--csv", str(bop_tree / "b.csv"), "--data_dir", str(bop_tree), "--dataset", DATASET]
    got, ref = _run_both(capsys, monkeypatch, base + flags)
    assert got == ref
    assert got["n_gt"] == 5 and 0.0 < got["AR_MSSD"] < 1.0
    if "--vsd" in flags:
        assert 0.0 < got["AR_VSD"] <= 1.0 and got["AR_bop19"] == pytest.approx(
            (got["AR_MSSD"] + got["AR_MSPD"] + got["AR_VSD"]) / 3.0, rel=0, abs=1e-15)
    if "--bootstrap" in flags:
        assert set(got["ci95"]) == ({"AR_MSSD", "AR_MSPD", "AR_mssd_mspd"}
                                    | ({"AR_VSD", "AR_bop19"} if "--vsd" in flags else set()))


@pytest.mark.parametrize("dumped_by", ["jax", "port"])
def test_score_csv_paired_records_equal_the_jax_ones(bop_tree, capsys, monkeypatch, tmp_path, dumped_by):
    """Each package dumps arm A's records; each scores arm B against the
    records ``dumped_by`` wrote; the dumps and the JSON are equal."""
    data = ["--data_dir", str(bop_tree), "--dataset", DATASET, "--vsd"]
    dumps = {w: str(tmp_path / f"{w}.pkl") for w in ("port", "jax")}
    capsys.readouterr()
    score_csv.main(["--csv", str(bop_tree / "a.csv"), *data, "--dump_records", dumps["port"]])
    monkeypatch.setattr(sys, "argv", ["score_csv.py", "--csv", str(bop_tree / "a.csv"), *data,
                                      "--dump_records", dumps["jax"]])
    _jax_score_csv().main()
    with open(dumps["port"], "rb") as f, open(dumps["jax"], "rb") as g:
        _equal(pickle.load(f), pickle.load(g))
    got, ref = _run_both(capsys, monkeypatch, ["--csv", str(bop_tree / "b.csv"), *data, "--bootstrap", "30",
                                               "--paired_vs", dumps[dumped_by]])
    assert got == ref
    assert set(got["paired_delta_vs_baseline"]) == {"AR_MSSD", "AR_MSPD", "AR_mssd_mspd", "AR_VSD", "AR_bop19"}
    assert got["paired_delta_vs_baseline"]["AR_MSSD"]["n"] == 5
