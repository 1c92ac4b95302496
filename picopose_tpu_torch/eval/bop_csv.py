"""BOP-challenge CSV output (bop19 format).

The port's own copy of picopose_tpu/eval/bop_csv.py (:1-28), byte for byte
in what it writes: scene_id,im_id,obj_id,score,R (9 floats, row-major),
t (3 floats, mm),time (s), each float as Python's ``str`` of a float.
"""

from __future__ import annotations

import numpy as np


def format_row(
    scene_id: int,
    im_id: int,
    obj_id: int,
    score: float,
    R: np.ndarray,
    t_m: np.ndarray,
    time_s: float,
) -> str:
    r = " ".join(str(float(v)) for v in np.asarray(R).reshape(9))
    t = " ".join(str(float(v) * 1000.0) for v in np.asarray(t_m).reshape(3))
    return f"{scene_id},{im_id},{obj_id},{score},{r},{t},{time_s}\n"


def write_csv(path: str, rows: list[str]) -> None:
    with open(path, "w") as f:
        f.writelines(rows)
