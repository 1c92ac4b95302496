"""Hold the port's fp32 CPU results and the JAX package's against a float64
evaluation of the same computation, for the parity tests that once
depended on the host's vector width; prints the distances.

    JAX_PLATFORMS=cpu python tests/torch_float64_distances.py

1. The GT keypoint chain (tests/test_torch_train_geom.py, crop 112): the
   reprojection before ``trunc`` in numpy float64, on the JAX CPU path,
   and in the port with ``torch.matmul`` (its form before
   ``geom/fma.py``) and with ``apply_rows``: the points whose truncation
   differs from JAX's, and each path's largest and RMS distance from
   float64.
2. The first training step's gradients (tests/test_torch_train_step.py):
   relative RMS per parameter group from a float64 evaluation of the
   port's step (the model in ``.double()``; fp32 requests on float64
   tensors kept float64), for the JAX CPU step and the port's forward and
   backward with oneDNN on and off (``device.aten_cpu_convs``).
3. The DPT head's 3 x 3 stride-2 resize conv alone, channels-last, at its
   training shape: relative RMS from float64 with oneDNN on and off.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]  # the tests' helpers, both packages
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402


def keypoint_chain() -> None:
    from test_torch_train_geom import _view_pairs

    from picopose_tpu.geom.grids import patch_center_grid
    from picopose_tpu_torch.geom.fma import apply_rows

    crop, B, N = 112, 3, 4096
    b = _view_pairs(crop)
    T = np.einsum("bij,bjk->bik", b["real_pose"], np.linalg.inv(b["tem_pose"])).astype(np.float32)
    pts = np.trunc(np.broadcast_to(np.asarray(patch_center_grid(crop, crop / 64)).reshape(1, N, 2), (B, N, 2)))

    def chain(mm, inv, dt):
        """train/keypoints.py's roundtrip of the template grid into the query crop."""
        f = lambda a: np.asarray(a, dt)
        M_a, K_a, depth, M_b, K_b = b["tem_M"], b["tem_K"], b["tem_full_depth"], b["real_M"], b["real_K"]

        def aff(M, p):
            o = mm(M, np.concatenate([p, np.ones(p.shape[:-1] + (1,), dt)], -1))
            return o[..., :2] / o[..., 2:3]

        s = f(M_a[:, 0, 0])
        Minv = np.zeros_like(f(M_a))
        Minv[:, 0, 0] = Minv[:, 1, 1] = 1 / s
        Minv[:, :2, 2] = -f(M_a[:, :2, 2]) / s[:, None]
        Minv[:, 2, 2] = 1
        img = aff(Minv, f(pts))
        H0, W0 = depth.shape[-2:]
        img = np.stack([np.clip(img[..., 0], 0, W0 - 1), np.clip(img[..., 1], 0, H0 - 1)], -1)
        d = np.take_along_axis(f(depth).reshape(B, -1), img[..., 1].astype(np.int64) * W0 + img[..., 0].astype(np.int64), -1)
        rays = mm(inv(f(K_a)), np.concatenate([img, np.ones(img.shape[:-1] + (1,), dt)], -1)) * d[..., None]
        p3 = mm(f(T[:, :3, :3]), rays) + f(T[:, None, :3, 3])
        pr = mm(f(K_b), p3)
        return aff(f(M_b), pr[..., :2] / pr[..., 2:3])

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    tinv = lambda K: torch.linalg.inv(t(K)).numpy()
    paths = {
        "float64": chain(lambda M, x: np.einsum("bij,bnj->bni", M, x), np.linalg.inv, np.float64),
        "JAX CPU": chain(lambda M, x: np.asarray(jnp.einsum("...ij,...nj->...ni", M, x, precision="highest")),
                         lambda K: np.asarray(jnp.linalg.inv(K)), np.float32),
        "port, torch.matmul": chain(lambda M, x: torch.matmul(t(x), t(M).transpose(-1, -2)).numpy(), tinv, np.float32),
        "port, apply_rows": chain(lambda M, x: apply_rows(t(M), t(x)).numpy(), tinv, np.float32),
    }
    ref = paths["float64"]
    ok = np.isfinite(ref)
    for name, got in paths.items():
        e = np.abs(got - ref)[ok]
        differ = np.argwhere(np.trunc(got) != np.trunc(paths["JAX CPU"]))
        print(f"[keypoints] {name}: max |x - float64| {e.max():.3g}, RMS {np.sqrt((e ** 2).mean()):.3g}; "
              f"truncations unlike JAX's: {len(differ)}")
        for i in map(tuple, differ):
            print(f"[keypoints]   at {i}: float64 {ref[i]:.9f}, JAX {paths['JAX CPU'][i]:.9f}, {name} {got[i]:.9f}")


def _float64_step(reference) -> dict:
    """The port's first-step gradients with every tensor float64."""
    import test_torch_train_step as T

    from picopose_tpu_torch.train import step as ts

    real_float, real_to, real_einsum = torch.Tensor.float, torch.Tensor.to, torch.einsum
    default = torch.get_default_dtype()

    def to(x, *a, **k):
        if x.dtype == torch.float64 and ((a and a[0] is torch.float32) or k.get("dtype") is torch.float32):
            return x
        return real_to(x, *a, **k)

    def einsum(eq, *ops):
        ops = tuple(ops[0]) if len(ops) == 1 and isinstance(ops[0], (list, tuple)) else ops
        if any(o.dtype == torch.float64 for o in ops):
            ops = [o.double() if o.is_floating_point() else o for o in ops]
        return real_einsum(eq, *ops)

    state = T._state(reference)
    torch.Tensor.float = lambda x, *a, **k: x if x.dtype == torch.float64 else real_float(x, *a, **k)
    torch.Tensor.to, torch.einsum = to, einsum
    torch.set_default_dtype(torch.float64)
    try:
        model = state.model.double().train()
        batch = {k: v.astype(np.float64) if v.dtype == np.float32 else v for k, v in reference["batch"].items()}
        n = reference["noise"]
        noise = type(n)(*[x.double() if torch.is_tensor(x) and x.is_floating_point() else x for x in n])
        ts.forward_train(model, batch, noise)["loss"].backward()
    finally:
        torch.Tensor.float, torch.Tensor.to, torch.einsum = real_float, real_to, real_einsum
        torch.set_default_dtype(default)
    return {k: p.grad.numpy() for k, p in model.named_parameters() if p.grad is not None}


def step_gradients() -> None:
    import test_torch_train_step as T

    from picopose_tpu_torch.train import step as ts

    reference = T.reference.__pytest_wrapped__.obj() if hasattr(T.reference, "__pytest_wrapped__") \
        else T.reference._get_wrapped_function()()
    g64 = _float64_step(reference)
    grads = {"JAX CPU": reference["steps"][0]["grads"]}
    inner = ts.forward_train.__wrapped__.__wrapped__  # under neither full_fp32 nor aten_cpu_convs
    for name, onednn in (("port, oneDNN", True), ("port, oneDNN off", False)):
        state = T._state(reference)
        with torch.backends.mkldnn.flags(enabled=onednn):
            inner(state.model, reference["batch"], reference["noise"])["loss"].backward()
        grads[name] = {k: p.grad.numpy() for k, p in state.model.named_parameters() if p.grad is not None}
    for name, g in grads.items():
        rel = T._rel_rms_by_group(g, g64, keys=g64)
        print(f"[step] {name}: gradient relative RMS from float64 " + ", ".join(f"{k} {v:.3g}" for k, v in rel.items()))


def resize_conv() -> None:
    g = torch.Generator().manual_seed(0)
    x, w, bias = (torch.randn(s, generator=g, dtype=torch.float64) for s in ((2, 1024, 16, 16), (1024, 1024, 3, 3), (1024,)))
    ref = torch.nn.functional.conv2d(x, w, bias, stride=2, padding=1)
    for onednn in (True, False):
        with torch.backends.mkldnn.flags(enabled=onednn):
            y = torch.nn.functional.conv2d(x.float().contiguous(memory_format=torch.channels_last), w.float(),
                                           bias.float(), stride=2, padding=1)
        print(f"[conv] DPT resize_3 forward, oneDNN {'on' if onednn else 'off'}: relative RMS from float64 "
              f"{((y.double() - ref).norm() / ref.norm()).item():.3g}")


if __name__ == "__main__":
    print(f"torch {torch.__version__}, CPU capability {torch.backends.cpu.get_cpu_capability()}")
    keypoint_chain()
    resize_conv()
    step_gradients()
