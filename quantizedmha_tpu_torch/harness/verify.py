"""Numerical verification gates (counterpart of
quantizedmha_tpu/harness/verify.py).

The reference CUDA study's `verify_results` (its utils/verify.cu:153-173)
checks elementwise |a-b| <= max(abs_tol, rel_tol*|b|) and rejects any
non-finite value; this module is that gate plus a per-tensor error report.
It takes torch tensors or numpy arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ErrorReport:
    max_abs: float
    mean_abs: float
    max_rel: float  # max_abs / max|ref|
    n_mismatch: int  # elements violating max(abs_tol, rel_tol*|ref|)
    n_nonfinite: int
    abs_tol: float
    rel_tol: float

    @property
    def ok(self) -> bool:
        return self.n_mismatch == 0 and self.n_nonfinite == 0

    def __str__(self) -> str:
        status = "PASS" if self.ok else "FAIL"
        return (
            f"[{status}] max_abs={self.max_abs:.3e} mean_abs={self.mean_abs:.3e} "
            f"max_rel={self.max_rel:.3e} mismatches={self.n_mismatch} "
            f"nonfinite={self.n_nonfinite} (tol abs={self.abs_tol:g} rel={self.rel_tol:g})"
        )


def _np64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, dtype=np.float64)


def compare(got, ref, abs_tol: float = 1e-3, rel_tol: float = 1e-3) -> ErrorReport:
    """Elementwise gate: tol = max(abs_tol, rel_tol*|ref|); a non-finite
    element in EITHER tensor fails it."""
    got, ref = _np64(got), _np64(ref)
    if got.shape != ref.shape:
        raise ValueError(f"shape mismatch: {got.shape} vs {ref.shape}")
    finite = np.isfinite(got) & np.isfinite(ref)
    nonfinite = int(finite.size - np.sum(finite))
    diff = np.abs(got - ref)
    tol = np.maximum(abs_tol, rel_tol * np.abs(ref))
    mismatch = int(np.sum(finite & (diff > tol)))
    finite_diff = diff[finite]
    ref_scale = float(np.max(np.abs(ref))) if ref.size else 0.0
    max_abs = float(np.max(finite_diff)) if finite_diff.size else 0.0
    return ErrorReport(
        max_abs=max_abs,
        mean_abs=float(np.mean(finite_diff)) if finite_diff.size else 0.0,
        max_rel=max_abs / (ref_scale or 1.0),
        n_mismatch=mismatch,
        n_nonfinite=nonfinite,
        abs_tol=abs_tol,
        rel_tol=rel_tol,
    )


def assert_close(got, ref, abs_tol: float = 1e-3, rel_tol: float = 1e-3, what: str = ""):
    report = compare(got, ref, abs_tol=abs_tol, rel_tol=rel_tol)
    assert report.ok, f"{what} {report}"
    return report
