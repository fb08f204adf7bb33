"""State checkpoint/resume.  Full solver state (a, b, a_hs, b_hs, staleness
carries, av_data, t, step) round-trips through one .npz file in the layout
of ``slb2d_tpu/runtime/checkpoint.py``, so a checkpoint written by either
package loads in the other.
"""

from __future__ import annotations

import numpy as np

from ..ops.stencil import FIELDS, state_from_numpy, state_to_numpy


def save_state(path: str, state, *, model=None, **extra):
    arrays = {f"state_{k}": v for k, v in state_to_numpy(state).items()}
    arrays.update({f"extra_{k}": np.asarray(v) for k, v in extra.items()})
    if model is not None:
        arrays["meta_N"] = np.asarray(model.N)
        arrays["meta_M"] = np.asarray(model.M)
    np.savez_compressed(path, **arrays)


def load_state(path: str, model, device="cpu"):
    """(State on `device`, extra dict) from a checkpoint file."""
    with np.load(path) as data:
        kw = {field: data[f"state_{field}"] for field in FIELDS}
        meta = ((int(data["meta_N"]), int(data["meta_M"]))
                if "meta_N" in data else None)
        extra = {k[6:]: data[k] for k in data.files
                 if k.startswith("extra_")}
    # pre-Kahan checkpoints carried av as (6,); slots 6/7 are compensation
    # terms that legitimately start at zero
    if kw["av"].shape == (6,):
        kw["av"] = np.concatenate([kw["av"], np.zeros(2, kw["av"].dtype)])
    if kw["a"].shape != (model.NHP, model.MP):
        raise ValueError(
            f"checkpoint shape {kw['a'].shape} does not match configured "
            f"grid ({model.NHP}, {model.MP}) — n-harmonics/g-grid must match")
    if meta is not None and meta != (model.N, model.M):
        raise ValueError(
            f"checkpoint grid (N={meta[0]}, M={meta[1]}) does not match "
            f"configured (N={model.N}, M={model.M})")
    if kw["a"].dtype != model.np_dtype:
        raise ValueError(
            f"checkpoint dtype {kw['a'].dtype} does not match dtype= setting")
    return state_from_numpy(kw, device), extra
