"""Input validation DSL + slice balancing.

Mirrors the reference's errorcheck.m: a check-by-name validator with
auto-coercion (transpose row vectors, strip imaginary parts,
errorcheck.m:35-135) and the ``slicemaker`` worker-balancing rule
(errorcheck.m:216-267).  Host-side only — runs at solver setup, never
inside a traced program (trace-time shape/dtype checks are the compiled analog
of runtime sanitizers, SURVEY.md section 5)."""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np


def errorcheck(arg, check: str, name: str = "argument", *, opts: dict | None = None):
    """Validate (and possibly coerce) ``arg`` under the named check.

    Supported checks mirror errorcheck.m:35-135: ismatrix, issquare,
    isfat, isskinny, isvector, isnumber, ispositivereal,
    isnonnegativereal, isinteger, slices.  Returns the (coerced) value or
    raises ValueError.
    """
    if check == "slices":
        o = opts or {}
        return slicemaker(arg, o["slicelength"], o["workers"])

    if check == "isstruct":
        # MATLAB struct <-> Python dict (errorcheck.m:117): the options
        # pytree the solvers pass around.  Not coerced, just gated.
        if not isinstance(arg, dict):
            raise ValueError(
                f"{name} must be a struct (dict), got {type(arg).__name__}")
        return arg

    a = np.asarray(arg)
    if np.iscomplexobj(a):
        a = np.real(a)  # coerce like the reference (errorcheck.m:60-66)

    if check == "ismatrix":
        if a.ndim != 2:
            raise ValueError(f"{name} must be a matrix, got ndim {a.ndim}")
        return a
    if check == "issquare":
        if a.ndim != 2 or a.shape[0] != a.shape[1]:
            raise ValueError(f"{name} must be square, got {a.shape}")
        return a
    if check == "isfat":
        if a.ndim != 2 or a.shape[0] >= a.shape[1]:
            raise ValueError(f"{name} must be fat (rows < cols), got {a.shape}")
        return a
    if check == "isskinny":
        if a.ndim != 2 or a.shape[0] <= a.shape[1]:
            raise ValueError(f"{name} must be skinny (rows > cols), got {a.shape}")
        return a
    if check == "isvector":
        a = np.squeeze(a)
        if a.ndim != 1:
            raise ValueError(f"{name} must be a vector, got shape {np.shape(arg)}")
        return a
    if check == "isrowvector":
        # Reference auto-transposes columns to rows (errorcheck.m:35-135).
        if a.ndim == 2 and a.shape[1] == 1:
            a = a.T
        if not (a.ndim == 1 or (a.ndim == 2 and a.shape[0] == 1)):
            raise ValueError(f"{name} must be a row vector, got {np.shape(arg)}")
        return a.reshape(1, -1)
    if check == "iscolumnvector":
        if a.ndim == 2 and a.shape[0] == 1:
            a = a.T
        if not (a.ndim == 1 or (a.ndim == 2 and a.shape[1] == 1)):
            raise ValueError(f"{name} must be a column vector, got {np.shape(arg)}")
        return a.reshape(-1, 1)
    if check == "isnumber":
        if a.size != 1:
            raise ValueError(f"{name} must be a scalar")
        return float(a)
    if check in ("ispositivereal", "isnonnegativereal", "isinteger"):
        if a.size != 1:
            raise ValueError(f"{name} must be a scalar, got shape {a.shape}")
        v = float(a)
        if check == "ispositivereal":
            if not v > 0:
                raise ValueError(f"{name} must be positive, got {v}")
            return v
        if check == "isnonnegativereal":
            if not v >= 0:
                raise ValueError(f"{name} must be nonnegative, got {v}")
            return v
        if v != int(v):
            raise ValueError(f"{name} must be an integer, got {v}")
        return int(v)
    raise ValueError(f"unknown check {check!r}")


def slicemaker(slices: Union[int, Sequence[int]], slicelength: int, workers: int):
    """Balance ``slicelength`` elements over workers (errorcheck.m:216-267):

    - scalar k > 0: contiguous blocks of size k (last may be short)
    - 0: even split over ``workers``, remainder spread over the first slices
    - vector: used as-is, must sum to slicelength

    Returns a list of slice lengths.
    """
    if workers <= 0:
        raise ValueError(f"workers must be positive, got {workers}")
    if np.ndim(slices) == 0:
        k = int(slices)
        if k < 0:
            raise ValueError("slices scalar must be >= 0")
        if k == 0:
            base, rem = divmod(slicelength, workers)
            out = [base + (1 if i < rem else 0) for i in range(workers)]
            return [v for v in out if v > 0]
        out = []
        left = slicelength
        while left > 0:
            out.append(min(k, left))
            left -= out[-1]
        return out
    out = [int(v) for v in np.asarray(slices).ravel()]
    if any(v <= 0 for v in out):
        raise ValueError("slice lengths must be positive")
    if sum(out) != slicelength:
        raise ValueError(
            f"slices sum to {sum(out)}, expected {slicelength}"
        )
    return out
