"""BOP evaluation loop: dataset sweep -> poses -> bop19 CSV.

Counterpart of picopose_tpu/eval/runner.py (``RawImageCache`` :41,
``_stream_batches`` :76, ``evaluate_dataset`` :130):

  * instances are grouped by object across the whole dataset from
    metadata alone (no decode), and run in batches of ``batch_size``, the
    last one padded by repeating its last instance, so every batch has one
    shape;
  * a background thread decodes and crops the next batches through a
    thread pool into a bounded queue while the device runs the current
    one; a byte-capped LRU of decoded frames turns the object-major
    sweep's revisits of a frame into hits;
  * one TemplateBank per object, built once and dropped after its group;
  * each batch's results come back through a non-blocking copy into
    pinned host memory paired with a CUDA event; batch i's results are
    read after batch i + 2 is queued, by waiting on batch i's event alone
    (no device-wide synchronisation in the loop);
  * per-image time = its instances' share of their batches' time (the
    time between consecutive reads, divided by the batch's real instance
    count, not the padded size) plus the detector's ``seg_time``.

On the card each batch replays ``run_batch_graphed`` and each bank the
bank build's chunk programs, CUDA graphs in one ``GraphCache`` per run
(utils/graphs.py), as the JAX runner calls ``run_batch_jit``; the
decode thread pins its batches under the cache's lock, since a capture
refuses other threads' CUDA calls.  A ``pnp_draws`` callback (the CPU
parity tests' shared draws) runs on the host, which no graph holds: with
it every batch runs the eager ``run_batch``.

With a bf16 model the bf16-consumed weights are stored in bf16 first
(utils/precast.py, in place; outputs bitwise unchanged).

Several devices (``use_mesh``, the JAX package's mesh branch, :159-172,
208-209), data-parallel in one process: ``batch_size`` is rounded up to a
multiple of the device count, each batch's rows are split into equal
parts in device order, and each part runs on its device with that
device's replica of the model, copy of the bank, ``GraphCache`` and PnP
generator (one of each per distinct device; the model's own device keeps
the model, its bank and ``generator``); the results are gathered in row
order.  A ``pnp_draws`` callback is called once per part, in row order.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import queue
import threading
import time
from collections import OrderedDict

import numpy as np
import torch

from picopose_tpu_torch.data.bop import BOPTestDataset, load_template_views
from picopose_tpu_torch.device import indexed, resolve_device
from picopose_tpu_torch.eval.bop_csv import format_row, write_csv
from picopose_tpu_torch.eval.pipeline import Replica, build_bank_graphed, replica_on, run_batch, run_batch_graphed
from picopose_tpu_torch.utils.graphs import GraphCache
from picopose_tpu_torch.utils.precast import precast_inference_params

_BATCH_KEYS = ("rgb", "mask", "M", "K", "pts2d")


class RawImageCache:
    """Byte-capped LRU of decoded frames (uint8 RGB + K), shared by the
    decode threads.  A frame is decoded once: threads that ask for it
    while another decodes it wait for that decode (the decode threads of a
    batch mostly ask for the same few frames, and a Python-bound decoder,
    LZW TIFF or progressive JPEG, run by eight threads at once took eight
    times as long)."""

    def __init__(self, dataset: BOPTestDataset, budget_bytes: int = 2 << 30):
        self.dataset = dataset
        self.budget = budget_bytes
        self._store: OrderedDict[int, tuple] = OrderedDict()
        self._pending: dict[int, cf.Future] = {}
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, index: int):
        with self._lock:
            if index in self._store:
                self._store.move_to_end(index)
                self.hits += 1
                return self._store[index]
            pending = self._pending.get(index)
            if pending is not None:
                self.hits += 1
            else:
                mine = self._pending[index] = cf.Future()
        if pending is not None:
            return pending.result()  # the decoding thread's frame, or its error
        try:
            value = self.dataset.load_raw(index)  # decode outside the lock
        except BaseException as e:
            with self._lock:
                del self._pending[index]
            mine.set_exception(e)
            raise
        with self._lock:
            del self._pending[index]
            self.misses += 1
            self._store[index] = value
            self._bytes += value[0].nbytes
            while self._bytes > self.budget and len(self._store) > 1:
                _, (old, _k) = self._store.popitem(last=False)
                self._bytes -= old.nbytes
        mine.set_result(value)
        return value


def _stream_batches(
    dataset: BOPTestDataset,
    cache: RawImageCache,
    refs: list[tuple[int, int, dict]],
    batch_size: int,
    workers: int = 8,
    depth: int = 3,
    pin: threading.Lock | None = None,
):
    """Yield (chunk refs, real count, padded batch of CPU tensors, pinned
    under the lock ``pin`` when given) decoded in the background, at most
    ``depth`` ahead."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def decode(ref):
        img_idx, _inst_idx, det = ref
        rgb, K = cache.get(img_idx)
        return dataset.decode_instance(rgb, K, det)

    def produce():
        try:
            with cf.ThreadPoolExecutor(workers) as pool:
                for s in range(0, len(refs), batch_size):
                    if stop.is_set():
                        return
                    chunk = refs[s : s + batch_size]
                    insts = list(pool.map(decode, chunk))
                    pad = batch_size - len(chunk)
                    batch = {}
                    for name in _BATCH_KEYS:
                        arr = np.stack([getattr(i, name) for i in insts])
                        if pad:
                            arr = np.concatenate([arr, np.repeat(arr[-1:], pad, axis=0)])
                        t = torch.from_numpy(arr)
                        if pin is not None:
                            with pin:
                                t = t.pin_memory()
                        batch[f"real_{name}"] = t
                    q.put((chunk, len(chunk), batch))
            q.put(None)
        except BaseException as e:  # handed to the consumer, which raises it
            q.put(e)

    producer = threading.Thread(target=produce, daemon=True)
    producer.start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        while producer.is_alive():  # unblock a producer waiting on a full queue
            try:
                q.get(timeout=0.1)
            except queue.Empty:
                pass
        producer.join()


def _parts(home: Replica, devices) -> list[tuple[torch.device, Replica]]:
    """(device, replica) for each entry of ``devices`` (the model's own
    device when None): one replica per distinct device, the model's own
    device keeping ``home`` (eval/pipeline.py::replica_on)."""
    made: dict[torch.device, Replica] = {}
    parts = []
    for d in devices or [home.model.device]:
        d = indexed(resolve_device(d))
        if d not in made:
            made[d] = replica_on(home, d, seed=0)
        parts.append((d, made[d]))
    return parts


def evaluate_dataset(
    model,
    dataset: BOPTestDataset,
    template_dir: str,
    save_path: str,
    hyp: int = 5,
    batch_size: int = 16,
    pnp_iters: int = 150,
    stage3_topk: int | None = None,
    progress: bool = True,
    decode_workers: int = 8,
    cache_bytes: int = 2 << 30,
    generator: torch.Generator | None = None,
    pnp_draws=None,
    use_mesh: bool | None = None,
    devices=None,
) -> str:
    """Run the whole dataset through ``model`` (the port's PicoPose, on its
    device) and write the bop19 CSV to ``save_path``; returns the path.

    PnP draws come from ``generator`` (by default one on the model's
    device seeded with 0), or from ``pnp_draws(valid)`` for each batch in
    order, as ``run_batch`` takes them (the eager route).  ``use_mesh``:
    split each batch over ``devices`` (by default every card present;
    None: whether the model is on a card and more than one is present;
    the module docstring)."""
    dev = indexed(model.device)
    if use_mesh is None:
        use_mesh = dev.type == "cuda" and torch.cuda.device_count() > 1
    if use_mesh and devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if not use_mesh:
        devices = None
    if devices is not None:  # round batches up to a multiple of the devices
        batch_size = -(-batch_size // len(devices)) * len(devices)
    if model.compute_dtype == torch.bfloat16:
        precast_inference_params(model)  # outside inference mode: the weights stay normal tensors
    with torch.inference_mode():
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        cuda = dev.type == "cuda"
        graphs = GraphCache(dev)
        parts = _parts(Replica(model, graphs, generator), devices)
        per_part = batch_size // len(parts)

        # ---- metadata pass: group instance refs by object, no pixel decode
        n_images = len(dataset)
        metas = [dataset.image_meta(i) for i in range(n_images)]
        dets_per_image = [dataset.dets(i) for i in range(n_images)]
        by_obj: dict[int, list[tuple[int, int, dict]]] = {}
        for ii, dets in enumerate(dets_per_image):
            for k, det in enumerate(dets):
                by_obj.setdefault(det["category_id"], []).append((ii, k, det))
        if progress:
            n_inst = sum(len(d) for d in dets_per_image)
            print(
                f"[{dataset.dataset}] {n_images} images, {n_inst} instances, "
                f"{len(by_obj)} objects (streaming decode, {decode_workers} workers)"
            )

        cache = RawImageCache(dataset, budget_bytes=cache_bytes)
        results: dict[tuple[int, int], np.ndarray] = {}
        image_model_time = np.zeros(n_images)

        def drain(pending, mark: float) -> float:
            """Wait for one batch's results and record them; its time is the
            time since the previous read, shared by its real instances."""
            chunk, B, host, done = pending
            if done is not None:
                done.synchronize()
            rows = host.numpy()
            now = time.perf_counter()
            for bi, (img_idx, inst_idx, _det) in enumerate(chunk):
                results[(img_idx, inst_idx)] = rows[bi]
                image_model_time[img_idx] += (now - mark) / B
            return now

        for obj_id, refs in sorted(by_obj.items()):
            t0 = time.perf_counter()
            stream = _stream_batches(dataset, cache, refs, batch_size, workers=decode_workers,
                                     pin=graphs.lock if cuda else None)
            tem = load_template_views(
                template_dir, obj_id, dataset.n_template_view,
                dataset.img_size, dataset.pts_size, dataset.rgb_mask_flag,
            )
            bank = build_bank_graphed(
                graphs, model, tem["tem_rgb"], tem["tem_mask"], tem["tem_pts3d"],
                tem["tem_pose"], tem["tem_K"], tem["tem_M"],
            )
            banks = {d: bank if d == dev else bank.to(d) for d, _ in parts}
            if progress:
                print(
                    f"[{dataset.dataset}] obj {obj_id}: bank ({dataset.n_template_view} views) "
                    f"queued in {time.perf_counter() - t0:.1f}s; {len(refs)} instances"
                )

            # depth-2 pipeline: queue batch i, then read batch i - 2, so the
            # host's work on the next batches overlaps the device's on these
            pending: list = []
            mark = time.perf_counter()
            for chunk, B, batch in stream:
                outs = []
                for i, (d, rep) in enumerate(parts):  # in row order
                    rows = slice(i * per_part, (i + 1) * per_part)
                    b = {k: v[rows].to(d, non_blocking=True) for k, v in batch.items()}
                    kw = dict(hyp=hyp, pnp_iters=pnp_iters, stage3_topk=stage3_topk, generator=rep.generator)
                    if pnp_draws is None:
                        out = run_batch_graphed(rep.graphs, rep.model, b, banks[d], **kw)
                    else:
                        out = run_batch(rep.model, b, banks[d], pnp_draws=pnp_draws, **kw)
                    n = min(per_part, max(B - i * per_part, 0))
                    outs.append(torch.cat([out.R[:n, 0].reshape(n, 9), out.t[:n, 0]], dim=1).to(dev))
                packed = outs[0] if len(outs) == 1 else torch.cat(outs)
                host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=cuda)
                host.copy_(packed, non_blocking=cuda)
                done = None
                if cuda:
                    done = torch.cuda.Event()
                    done.record()
                pending.append((chunk, B, host, done))
                if len(pending) > 2:
                    mark = drain(pending.pop(0), mark)
            for p in pending:
                mark = drain(p, mark)
            del bank, banks

        if progress:
            tot = cache.hits + cache.misses
            print(
                f"[{dataset.dataset}] image cache: {cache.hits}/{tot} hits "
                f"({cache.misses} decodes for {n_images} images)"
            )

        # ---- CSV (from metadata; the crops are long gone)
        rows = []
        total_time = 0.0
        for ii, meta in enumerate(metas):
            img_time = image_model_time[ii] + meta.seg_time
            total_time += img_time
            for k, det in enumerate(dets_per_image[ii]):
                res = results[(ii, k)]
                rows.append(
                    format_row(
                        meta.scene_id, meta.img_id, det["category_id"],
                        det["score"], res[:9], res[9:12], img_time,
                    )
                )
        if progress and n_images:
            print(f"[{dataset.dataset}] mean per-image time {total_time / n_images:.3f}s")

        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        write_csv(save_path, rows)
        return save_path
