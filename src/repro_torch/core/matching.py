"""Two-step tensorize matching (paper §IV-B).

Given an intrinsic TST ``Q`` and a compute TST, enumerate every legal
*tensorize choice*: a bijective mapping from the intrinsic's leaf occurrences
onto a subset ``P`` of the compute tree's leaves such that

  index matching:
    ① |P| = |Q|  (leaf-for-leaf),
    ② leaves of Q carrying the same index map to compute leaves carrying the
      same index (and distinct intrinsic indices map to distinct compute
      indices) — i.e. the mapping factors through an injective index map σ,
    ②' occurrence counts agree: if an intrinsic index occurs r times, its
      image must occur exactly r times in the compute tree (otherwise an
      unmapped occurrence of the same loop would vary *inside* one intrinsic
      call, which no fixed-operand intrinsic can implement),
    ②'' reduction soundness: an index the intrinsic reduces must map to an
      index the computation reduces (the intrinsic's output has summed it
      away — mapping it to a free index would be irrecoverable).  The
      converse is fine: a compute-reduced index mapped to an intrinsic-free
      index is accumulated by the software loop nest (Listing 1's ``sC +=``).

  structure matching:
    for every pair of intrinsic leaves (νa, νb), the operation kind of
    LCA(μa, μb) in the compute tree equals the kind of LCA(νa, νb) in the
    intrinsic tree.  This rejects e.g. mapping GEMM's (i, k) onto conv's
    (y, s), whose LCA is the affine ``y+s`` node rather than an access.

Unmapped compute loops become the *software loops* that the schedule
(``repro.core.sw_primitives``) splits/reorders/fuses around the interface.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field

from .tst import Leaf, TensorExpr, lca_kind, leaves


@dataclass(frozen=True)
class TensorizeChoice:
    """One legal HW/SW partitioning of ``workload`` onto ``intrinsic``."""

    intrinsic_name: str
    workload_name: str
    index_map: tuple[tuple[str, str], ...]   # (intrinsic index -> compute index)
    leaf_map: tuple[tuple[tuple[int, ...], tuple[int, ...]], ...]  # ν path -> μ path
    software_loops: tuple[str, ...]          # unmapped compute indices
    accumulation: bool                       # software must accumulate output
    transposed: bool                         # operand order differs from canonical

    @property
    def mapped_compute_indices(self) -> tuple[str, ...]:
        return tuple(c for _, c in self.index_map)

    @property
    def leaf_subset(self) -> frozenset[tuple[int, ...]]:
        """The compute-leaf subset P (the paper counts choices by subsets)."""
        return frozenset(mu for _, mu in self.leaf_map)

    def describe(self) -> str:
        m = ", ".join(f"{q}->{c}" for q, c in self.index_map)
        sw = ",".join(self.software_loops)
        flags = []
        if self.accumulation:
            flags.append("accum")
        if self.transposed:
            flags.append("transposed")
        return (f"{self.workload_name} on {self.intrinsic_name}: [{m}] "
                f"software loops [{sw}]" + (f" ({'+'.join(flags)})" if flags else ""))


def _group_by_index(ls: list[Leaf]) -> dict[str, list[Leaf]]:
    out: dict[str, list[Leaf]] = {}
    for l in ls:
        out.setdefault(l.index, []).append(l)
    return out


def match(intrinsic: TensorExpr, workload: TensorExpr,
          max_choices: int = 4096) -> list[TensorizeChoice]:
    """Enumerate all legal tensorize choices of ``workload`` on ``intrinsic``.

    Complexity is bounded by the paper's O(C(m,n) · l); we enumerate at the
    index level (injective maps σ) and then occurrence pairings, which visits
    a subset of the C(m,n) leaf subsets.
    """
    q_leaves = leaves(intrinsic.body)
    c_leaves = leaves(workload.body)
    q_groups = _group_by_index(q_leaves)
    c_groups = _group_by_index(c_leaves)

    q_indices = sorted(q_groups, key=lambda i: (-len(q_groups[i]), i))
    c_index_pool = sorted(c_groups)

    choices: list[TensorizeChoice] = []

    def candidates(qi: str) -> list[str]:
        out = []
        for ci in c_index_pool:
            if len(c_groups[ci]) != len(q_groups[qi]):
                continue  # ②' occurrence counts must agree
            if qi in intrinsic.reduced and ci not in workload.reduced:
                continue  # ②'' intrinsic-reduced -> compute-reduced only
            out.append(ci)
        return out

    def structure_ok(leaf_map: dict[tuple[int, ...], tuple[int, ...]]) -> bool:
        items = list(leaf_map.items())
        for (na, ma), (nb, mb) in itertools.combinations(items, 2):
            if lca_kind(intrinsic.body, na, nb) != lca_kind(workload.body, ma, mb):
                return False
        return True

    def rec(pos: int, sigma: dict[str, str], used: set[str]) -> None:
        if len(choices) >= max_choices:
            return
        if pos == len(q_indices):
            _emit(sigma)
            return
        qi = q_indices[pos]
        for ci in candidates(qi):
            if ci in used:
                continue
            sigma[qi] = ci
            used.add(ci)
            rec(pos + 1, sigma, used)
            used.discard(ci)
            del sigma[qi]

    def _emit(sigma: dict[str, str]) -> None:
        # enumerate occurrence pairings for multi-occurrence indices
        per_index_pairings: list[list[list[tuple[Leaf, Leaf]]]] = []
        for qi, ci in sigma.items():
            qs, cs = q_groups[qi], c_groups[ci]
            pairings = [list(zip(qs, perm)) for perm in itertools.permutations(cs)]
            per_index_pairings.append(pairings)
        for combo in itertools.product(*per_index_pairings):
            leaf_map = {q.path: c.path for pairing in combo for q, c in pairing}
            if not structure_ok(leaf_map):
                continue
            software = tuple(i for i in workload.all_indices()
                             if i not in sigma.values())
            # software loops that are reduced, or compute-reduced indices mapped
            # to intrinsic-free ones, require accumulation outside the call
            accum = any(i in workload.reduced for i in software) or any(
                ci in workload.reduced and qi not in intrinsic.reduced
                for qi, ci in sigma.items())
            transposed = _is_transposed(intrinsic, workload, leaf_map)
            choices.append(TensorizeChoice(
                intrinsic.name, workload.name,
                tuple(sorted(sigma.items())),
                tuple(sorted(leaf_map.items())),
                software, accum, transposed))
            if len(choices) >= max_choices:
                return

    rec(0, {}, set())

    # deduplicate identical leaf maps (possible via symmetric pairings)
    uniq: dict[tuple, TensorizeChoice] = {}
    for ch in choices:
        uniq.setdefault(ch.leaf_map, ch)
    return list(uniq.values())


def _is_transposed(intrinsic: TensorExpr, workload: TensorExpr,
                   leaf_map: dict[tuple[int, ...], tuple[int, ...]]) -> bool:
    """True if any mapped operand's leaf order differs from the intrinsic's —
    i.e. the interface must rearrange data (Fig. 4 choice #3)."""
    q_leaves = {l.path: l for l in leaves(intrinsic.body)}
    c_leaves = {l.path: l for l in leaves(workload.body)}
    by_tensor: dict[str, list[tuple[tuple[int, ...], tuple[int, ...]]]] = {}
    for nu, mu in leaf_map.items():
        by_tensor.setdefault(q_leaves[nu].tensor, []).append((nu, mu))
    for pairs in by_tensor.values():
        pairs.sort(key=lambda p: p[0])  # intrinsic dim order
        mu_dims = [ (c_leaves[mu].tensor, c_leaves[mu].dim) for _, mu in pairs ]
        if any(mu_dims[i][0] == mu_dims[i + 1][0] and mu_dims[i][1] > mu_dims[i + 1][1]
               for i in range(len(mu_dims) - 1)):
            return True
    return False


def legal_leaf_subsets(intrinsic: TensorExpr, workload: TensorExpr) -> set[frozenset]:
    """The paper reports choice counts as distinct legal leaf *subsets*
    (e.g. six for GEMM on 2D convolution)."""
    return {c.leaf_subset for c in match(intrinsic, workload)}


def partition_space(intrinsics: list[TensorExpr],
                    workloads: list[TensorExpr]) -> dict[tuple[str, str], list[TensorizeChoice]]:
    """Step 1 of Fig. 3: the full partition space, keyed by
    (workload, intrinsic)."""
    space: dict[tuple[str, str], list[TensorizeChoice]] = {}
    for w in workloads:
        for q in intrinsics:
            found = match(q, w)
            if found:
                space[(w.name, q.name)] = found
    return space
