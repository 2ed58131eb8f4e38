"""Ordered groups of parameter blocks.

Port of `ceres_tpu.ordering` (reference: include/ceres/ordered_groups.h,
ParameterBlockOrdering = OrderedGroups<double*>, keyed here by
parameter-block handles). The lowest group is the set the Schur solvers
eliminate (reorder_program.cc); higher groups are kept for the API and
validation but do not change the Program's layout, whose class-contiguous
tables fix the order within each side of the partition.
"""

from __future__ import annotations

from typing import Dict, Iterable, List


class ParameterBlockOrdering:
    """Mutable mapping handle -> group id with the reference's surface."""

    def __init__(self):
        self._group_of: Dict[int, int] = {}

    def add_element_to_group(self, element: int, group: int) -> bool:
        """Add (or move) a parameter-block handle to a group. Returns True
        on success, False for a negative group id.

        reference: OrderedGroups::AddElementToGroup (ordered_groups.h:53)
        returns bool with exactly this contract.
        """
        if group < 0:
            return False
        self._group_of[int(element)] = int(group)
        return True

    def remove(self, element: int) -> bool:
        """Remove a handle; True if it was present
        (OrderedGroups::Remove)."""
        return self._group_of.pop(int(element), None) is not None

    def clear(self) -> None:
        self._group_of.clear()

    def reverse(self) -> None:
        """Reverse the order of the groups in place.

        reference: OrderedGroups::Reverse (ordered_groups.h) anchors the
        new ids at the current largest id and counts upward, so the
        absolute ids observable via group_id() match the reference.
        """
        if not self._group_of:
            return
        ids = sorted(set(self._group_of.values()))
        base = ids[-1]
        remap = {g: base + i for i, g in enumerate(reversed(ids))}
        for e in list(self._group_of):
            self._group_of[e] = remap[self._group_of[e]]

    def group_id(self, element: int) -> int:
        """Group of a handle, or -1 if absent (OrderedGroups::GroupId)."""
        return self._group_of.get(int(element), -1)

    def is_member(self, element: int) -> bool:
        return int(element) in self._group_of

    def group_size(self, group: int) -> int:
        return sum(1 for g in self._group_of.values() if g == int(group))

    @property
    def num_elements(self) -> int:
        return len(self._group_of)

    @property
    def num_groups(self) -> int:
        return len(set(self._group_of.values()))

    def min_non_zero_group(self) -> int:
        """Smallest group id with members (OrderedGroups::MinNonZeroGroup;
        the reference requires a non-empty ordering)."""
        if not self._group_of:
            raise ValueError("ordering is empty")
        return min(self._group_of.values())

    def group_to_elements(self) -> Dict[int, List[int]]:
        """Map group id -> sorted handles (OrderedGroups::group_to_elements)."""
        out: Dict[int, List[int]] = {}
        for e, g in self._group_of.items():
            out.setdefault(g, []).append(e)
        for g in out:
            out[g].sort()
        return out

    def elements_in_group(self, group: int) -> List[int]:
        return self.group_to_elements().get(int(group), [])

    def eliminated_blocks(self) -> List[int]:
        """Handles in the first (lowest-numbered) group — what the Schur
        solvers eliminate. The reference treats the lowest group of
        linear_solver_ordering the same way (reorder_program.cc:
        the first group forms the e-blocks)."""
        if not self._group_of:
            return []
        g0 = self.min_non_zero_group()
        return self.elements_in_group(g0)


def eliminated_handles(ordering) -> Iterable[int]:
    """Normalize a user ordering option: a ParameterBlockOrdering (its
    first group) or a flat iterable of handles."""
    if isinstance(ordering, ParameterBlockOrdering):
        return ordering.eliminated_blocks()
    return ordering
