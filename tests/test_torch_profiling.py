"""The port's profiling helpers (picopose_tpu_torch/utils/profiling.py)
on the CPU: ``timed``'s warm-up and timed calls, ``StageTimer``'s counts,
totals and report (the JAX module's format, checked against
picopose_tpu.utils.profiling.StageTimer filled with the same totals),
``trace`` writing a Chrome trace, and none of them starting CUDA."""

import json
import os
import re
import subprocess
import sys
import time

import pytest
import torch

from picopose_tpu.utils import profiling as J
from picopose_tpu_torch.utils import profiling as P

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("warmup,iters", [(0, 1), (1, 5), (3, 2)])
def test_timed_counts_calls_and_returns_the_last_result(warmup, iters):
    calls = []

    def fn(x, scale=1):
        calls.append(x)
        time.sleep(0.002)
        return torch.full((2,), float(len(calls) * scale))

    seconds, result = P.timed(fn, 7, warmup=warmup, iters=iters, scale=2)
    assert calls == [7] * (warmup + iters)
    assert torch.equal(result, torch.full((2,), 2.0 * (warmup + iters)))
    assert 0.002 <= seconds < 1.0


def test_stage_timer_counts_and_report_format():
    timer = P.StageTimer()
    for _ in range(3):
        with timer.section("decode"):
            time.sleep(0.001)
    with timer.section("build bank", sync=False):
        pass
    assert dict(timer.counts) == {"decode": 3, "build bank": 1}
    assert timer.totals["decode"] >= 0.003 and timer.totals["build bank"] >= 0.0
    report = timer.report()
    assert re.fullmatch(r"build bank: \d+\.\d{3}s/1 \| decode: \d+\.\d{3}s/3", report), report
    ref = J.StageTimer()
    ref.totals.update(timer.totals)
    ref.counts.update(timer.counts)
    assert report == ref.report()
    assert P.StageTimer().report() == J.StageTimer().report() == ""


def test_trace_writes_a_chrome_trace(tmp_path):
    with P.trace(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = tmp_path / "trace" / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_nothing_starts_cuda():
    code = ("import torch; from picopose_tpu_torch.utils import profiling as P; "
            "t = P.StageTimer()\n"
            "with t.section('a'): pass\n"
            "P.timed(lambda: 1, iters=2); P.synchronize(); print(torch.cuda.is_initialized())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "False"
