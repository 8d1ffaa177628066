"""Block (multi-field) vectors.

Port of :mod:`sigma_tpu.vectors` (the reference's ``vectors.f90``: a flat
``val(:)`` array plus per-field pointers, ``init_multi_vector:55``, so a
vector over several physical fields is addressed flat or by (field,
index), ``vec_get_value_multi_index:92``).  :class:`BlockVector` is one
flat tensor plus static field sizes.  A field is a view of the flat
tensor; the mutators are functional and return a new vector, as in the
JAX package.  The flat layout is what the solvers take, so a BlockVector
goes into ``cg_solve`` as ``.values`` with no copy.

Many right-hand sides are not this class: the multi-RHS products take
plain (n, k) tensors (``matmat``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from sigma_tpu_torch.utils.device import resolve_device
from sigma_tpu_torch.utils.dtypes import default_real_dtype, to_numpy

__all__ = ["BlockVector"]


def _as_tensor(values, device) -> torch.Tensor:
    """A tensor stays on its device unless ``device`` is given; host data
    goes to ``device`` (None: CUDA)."""
    if isinstance(values, torch.Tensor):
        return values if device is None else values.to(device)
    return torch.as_tensor(np.asarray(values), device=resolve_device(device))


@dataclasses.dataclass(frozen=True, repr=False, eq=False)
class BlockVector:
    """Flat storage and a static partition into fields."""

    values: torch.Tensor  # (sum(field_sizes),)
    field_sizes: Tuple[int, ...]

    # -- construction --------------------------------------------------------
    @classmethod
    def zeros(cls, field_sizes: Sequence[int], dtype=None, device=None) -> "BlockVector":
        sizes = tuple(int(s) for s in field_sizes)
        return cls(values=torch.zeros(sum(sizes), dtype=dtype or default_real_dtype(),
                                      device=resolve_device(device)),
                   field_sizes=sizes)

    @classmethod
    def from_fields(cls, fields: Sequence, device=None) -> "BlockVector":
        """Concatenate the fields (tensors stay on their device unless
        ``device`` is given; host arrays go to ``device``, None: CUDA)."""
        arrs = [_as_tensor(f, device) for f in fields]
        return cls(values=torch.cat(arrs), field_sizes=tuple(int(a.shape[0]) for a in arrs))

    @classmethod
    def from_flat(cls, values, field_sizes: Sequence[int], device=None) -> "BlockVector":
        """Wrap a flat vector (a tensor is not copied unless ``device``
        moves it)."""
        values = _as_tensor(values, device)
        sizes = tuple(int(s) for s in field_sizes)
        if values.shape[0] != sum(sizes):
            raise ValueError(f"flat length {values.shape[0]} != sum of fields {sum(sizes)}")
        return cls(values=values, field_sizes=sizes)

    # -- meta ----------------------------------------------------------------
    @property
    def num_fields(self) -> int:
        return len(self.field_sizes)

    @property
    def size(self) -> int:
        return sum(self.field_sizes)

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.field_sizes)])

    def _slice(self, field: int) -> slice:
        off = self.offsets
        return slice(int(off[field]), int(off[field + 1]))

    # -- access (flat and by field) --------------------------------------------
    def field(self, field: int) -> torch.Tensor:
        """A view of one field (the reference's field pointer)."""
        return self.values[self._slice(field)]

    def get(self, index: int, field: int = None) -> float:
        if field is None:
            return float(self.values[index])
        return float(self.field(field)[index])

    def _flat_index(self, index, field):
        if field is None:
            return index
        # a negative index wraps within the field, not at the flat end
        # (where it would address another field's element)
        sl = self._slice(field)
        size = sl.stop - sl.start
        if not -size <= index < size:
            raise IndexError(f"index {index} out of range for field {field} (size {size})")
        return sl.start + (index % size)

    def _replaced(self, values) -> "BlockVector":
        return dataclasses.replace(self, values=values)

    def set(self, index, value, field: int = None) -> "BlockVector":
        values = self.values.clone()
        values[self._flat_index(index, field)] = value
        return self._replaced(values)

    def add(self, index, value, field: int = None) -> "BlockVector":
        values = self.values.clone()
        values[self._flat_index(index, field)] += value
        return self._replaced(values)

    def with_field(self, field: int, values) -> "BlockVector":
        values = torch.as_tensor(values, dtype=self.dtype, device=self.device)
        sl = self._slice(field)
        if values.shape[0] != sl.stop - sl.start:
            raise ValueError("field size mismatch")
        out = self.values.clone()
        out[sl] = values
        return self._replaced(out)

    # -- arithmetic ------------------------------------------------------------
    def __add__(self, other):
        return self._replaced(self.values + self._vals_of(other))

    def __sub__(self, other):
        return self._replaced(self.values - self._vals_of(other))

    def __mul__(self, alpha):
        return self._replaced(self.values * alpha)

    __rmul__ = __mul__

    def dot(self, other) -> torch.Tensor:
        return torch.vdot(self.values, self._vals_of(other))

    def norm(self) -> torch.Tensor:
        return torch.linalg.vector_norm(self.values)

    def _vals_of(self, other):
        if isinstance(other, BlockVector):
            if other.field_sizes != self.field_sizes:
                raise ValueError("field partition mismatch")
            return other.values
        return torch.as_tensor(other, device=self.device)

    def to_numpy(self) -> np.ndarray:
        return to_numpy(self.values)

    def __repr__(self) -> str:
        return f"BlockVector(fields={self.field_sizes}, dtype={self.dtype}, device={self.device})"
