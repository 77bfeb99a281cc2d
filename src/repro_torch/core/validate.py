"""Input guardrails for LiNGAM fits: reject degenerate datasets *before*
any device work.

A DirectLiNGAM fit silently degrades on bad input — NaN/Inf cells poison
every covariance, a constant variable makes the regression residuals
undefined (divide-by-zero variance), duplicate variables make the mixing
matrix unidentifiable, and p > n leaves the empirical covariance rank-
deficient so the Cholesky adjacency phase is solving a singular system.
None of these raise inside jit; they come back as NaN orders or garbage
adjacencies after the full device round-trip (and, in the serving engines,
after burning a batched dispatch + retry budget on work that can never
succeed).

:func:`validate_dataset` runs the cheap host-side checks once at admission
and returns a :class:`DatasetDiagnostics`; :func:`require_valid` raises a
typed :class:`DatasetError` carrying those diagnostics. The serving engines
call this at ``submit`` time (``LingamServeConfig.validate``) so a bad
dataset is rejected in microseconds with an actionable message instead of
occupying a batch slot; ``fit(validate=True)`` offers the same guard on the
direct path.

Convention: datasets are ``(p, n)`` — variables are rows, samples are
columns (the transpose of the sklearn layout). "Duplicate variables" are
therefore duplicate *rows* here.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


class DatasetError(ValueError):
    """A dataset failed admission validation; ``.diagnostics`` carries the
    full :class:`DatasetDiagnostics` (which checks fired and where)."""

    def __init__(self, message: str, diagnostics: "DatasetDiagnostics"):
        super().__init__(message)
        self.diagnostics = diagnostics


@dataclass(frozen=True)
class DatasetDiagnostics:
    """What the admission checks found for one ``(p, n)`` dataset."""

    p: int
    n: int
    nonfinite_cells: int = 0  # NaN/Inf entries anywhere in the matrix
    constant_rows: tuple = ()  # zero-variance variables (indices)
    duplicate_rows: tuple = ()  # exact duplicates of an earlier variable
    rank_deficient: bool = False  # p > n: singular empirical covariance
    issues: tuple = field(default=())  # human-readable, one per failed check

    @property
    def ok(self) -> bool:
        return not self.issues

    def summary(self) -> str:
        if self.ok:
            return f"dataset ({self.p}, {self.n}): ok"
        return (f"dataset ({self.p}, {self.n}): "
                + "; ".join(self.issues))


def validate_dataset(x, *, check_duplicates: bool = True) -> DatasetDiagnostics:
    """Run every admission check on ``x`` and report, never raise (shape
    errors aside, everything is collected into one diagnostics object so a
    caller sees all problems at once, not just the first)."""
    arr = np.asarray(x, dtype=np.float64)
    if arr.ndim != 2:
        return DatasetDiagnostics(
            p=0, n=0,
            issues=(f"expected one (p, n) dataset, got shape {arr.shape}",))
    p, n = arr.shape
    issues = []
    if p < 1 or n < 2:
        issues.append(f"need p >= 1 variables and n >= 2 samples, got ({p}, {n})")

    finite = np.isfinite(arr)
    nonfinite = int(arr.size - int(finite.sum()))
    if nonfinite:
        rows = np.unique(np.nonzero(~finite)[0])[:8]
        issues.append(
            f"{nonfinite} non-finite cell(s) (NaN/Inf), e.g. in variable(s) "
            f"{rows.tolist()}")

    constant: tuple = ()
    duplicates: tuple = ()
    if n >= 2 and nonfinite == 0:
        # variance/duplicate checks are only meaningful on finite data
        spread = arr.max(axis=1) - arr.min(axis=1)
        constant = tuple(int(i) for i in np.nonzero(spread == 0.0)[0])
        if constant:
            issues.append(
                f"constant (zero-variance) variable(s) {list(constant)}: "
                f"residual regressions are undefined")
        if check_duplicates and p >= 2:
            _, first = np.unique(arr, axis=0, return_index=True)
            dup = sorted(set(range(p)) - set(int(i) for i in first))
            duplicates = tuple(dup)
            if duplicates:
                issues.append(
                    f"duplicate variable row(s) {list(duplicates)}: the "
                    f"mixing matrix is unidentifiable")

    rank_deficient = p > n
    if rank_deficient:
        issues.append(
            f"p={p} > n={n}: empirical covariance is rank-deficient; the "
            f"adjacency solve is singular")

    return DatasetDiagnostics(
        p=p, n=n, nonfinite_cells=nonfinite, constant_rows=constant,
        duplicate_rows=duplicates, rank_deficient=rank_deficient,
        issues=tuple(issues))


def require_valid(x, *, check_duplicates: bool = True) -> DatasetDiagnostics:
    """Raise :class:`DatasetError` if ``x`` fails any admission check;
    returns the (clean) diagnostics otherwise."""
    diag = validate_dataset(x, check_duplicates=check_duplicates)
    if not diag.ok:
        raise DatasetError(diag.summary(), diag)
    return diag


__all__ = ["DatasetError", "DatasetDiagnostics", "validate_dataset",
           "require_valid"]
