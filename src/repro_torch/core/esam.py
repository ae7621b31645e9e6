# Verbatim copy of src/repro/core/esam.py (no imports of repro).
"""Enhanced Suffix Automaton (ESAM) — the paper's core structure (§4.1, §4.3).

States are poslist-equivalence classes of patterns over a *collection* of
sequences (Definition 3).  Each state carries:
  * ``maxlen``  — length of the state's maximal pattern (Definition 4),
  * ``link``    — suffix link (Definition 6, appendix D),
  * ``trans``   — outgoing transitions, one per symbol (Lemma 3),
  * ``ids``     — the set of sequence/vector IDs whose sequences contain the
                  state's patterns ("ID propagation", Algorithm 3 line 16).

Construction is the online generalized-SAM extension (Algorithm 3 lines 2-15
plus appendix D): per sequence we reset ``last`` to the root; per symbol we
either reuse an existing equivalence class, create one new state, or split a
class with a clone.  Amortized O(1) per symbol; O(m) states (Lemma 1).

Hardware adaptation note (DESIGN.md §2): the automaton is a branchy,
pointer-chasing DFA and lives on the *host*.  It is stored struct-of-arrays
(int32 NumPy arrays + one dict per state for transitions) so it serializes
zero-copy into checkpoints and the walk stays cache-friendly.  All numeric
search work referenced by its states runs on device (see vectormaton.py).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

ROOT = 0
_NO_LINK = -1


class ESAM:
    """Enhanced suffix automaton over a collection of sequences.

    Symbols are arbitrary hashables (usually single characters or small ints).
    Sequence IDs are assigned by insertion order (0, 1, 2, ...), matching the
    paper's vector-ID == sequence-ID convention.
    """

    def __init__(self) -> None:
        # Struct-of-arrays state storage.  Python lists during construction
        # (amortized O(1) append); finalize() exposes NumPy views.
        self.maxlen: List[int] = [0]
        self.link: List[int] = [_NO_LINK]
        self.trans: List[Dict[object, int]] = [{}]
        # ID propagation: per-state list of sequence IDs, strictly increasing
        # because sequences are inserted in ID order -> O(1) membership check
        # against the tail ("stop at first state that already contains i").
        self.ids: List[List[int]] = [[]]
        self.num_sequences: int = 0
        self.total_symbols: int = 0
        # Set by finalize():
        self._ids_np: Optional[List[np.ndarray]] = None
        self._topo: Optional[np.ndarray] = None

    # ------------------------------------------------------------------ #
    # construction
    # ------------------------------------------------------------------ #

    def _new_state(self, maxlen: int, link: int, trans: Dict[object, int],
                   ids: List[int]) -> int:
        self.maxlen.append(maxlen)
        self.link.append(link)
        self.trans.append(trans)
        self.ids.append(ids)
        return len(self.maxlen) - 1

    def _extend(self, last: int, c: object) -> int:
        """One extension step (Algorithm 3 lines 5-15; appendix D cases)."""
        maxlen, link, trans = self.maxlen, self.link, self.trans
        tl = trans[last]
        q = tl.get(c)
        if q is not None:
            # The 'second segment' starts at `last` itself (Lemma 7 trivially).
            if maxlen[q] == maxlen[last] + 1:
                # Lemma 8: B already represents the extended class.
                return q
            # Lemma 9: split q -> clone represents poslist(q) + new occurrence.
            clone = self._new_state(maxlen[last] + 1, link[q], dict(trans[q]),
                                    list(self.ids[q]))
            link[q] = clone
            p = last
            while p != _NO_LINK and trans[p].get(c) == q:
                trans[p][c] = clone
                p = link[p]
            return clone

        cur = self._new_state(maxlen[last] + 1, _NO_LINK, {}, [])
        # First segment: suffix states lacking a c-transition all point to the
        # single new state (Lemma 5).
        p = last
        while p != _NO_LINK and c not in trans[p]:
            trans[p][c] = cur
            p = link[p]
        if p == _NO_LINK:
            link[cur] = ROOT           # appendix D.2 case 1
            return cur
        q = trans[p][c]
        if maxlen[q] == maxlen[p] + 1:
            link[cur] = q              # appendix D.2 case 2, no split
            return cur
        # Split: clone q so the clone's poslist absorbs the new occurrence.
        clone = self._new_state(maxlen[p] + 1, link[q], dict(trans[q]),
                                list(self.ids[q]))
        link[q] = clone
        link[cur] = clone
        while p != _NO_LINK and trans[p].get(c) == q:
            trans[p][c] = clone
            p = link[p]
        return cur

    def add_sequence(self, seq: Sequence) -> int:
        """Insert one sequence; returns its assigned ID.

        Implements the per-sequence loop of Algorithm 3 (lines 3-16) with
        online ID propagation after every symbol.
        """
        self._invalidate()
        seq_id = self.num_sequences
        self.num_sequences += 1
        last = ROOT
        ids, link = self.ids, self.link
        for c in seq:
            last = self._extend(last, c)
            # ID propagation (Algorithm 3 line 16): walk the suffix-link chain
            # from the state of the current full prefix, append seq_id until a
            # state already contains it (its ancestors then do too).
            p = last
            while p != _NO_LINK:
                lst = ids[p]
                if lst and lst[-1] == seq_id:
                    break
                lst.append(seq_id)
                p = link[p]
        # every sequence contains the empty pattern, so V_ROOT must hold
        # every id — the per-symbol propagation above only reaches ROOT for
        # non-empty sequences
        root_ids = ids[ROOT]
        if not root_ids or root_ids[-1] != seq_id:
            root_ids.append(seq_id)
        self.total_symbols += len(seq)
        return seq_id

    def add_sequences(self, seqs: Iterable[Sequence]) -> List[int]:
        return [self.add_sequence(s) for s in seqs]

    # ------------------------------------------------------------------ #
    # queries
    # ------------------------------------------------------------------ #

    def walk(self, pattern: Sequence) -> int:
        """Walk transitions along ``pattern``; -1 if it does not occur
        (Algorithm 3 lines 23-26)."""
        cur = ROOT
        trans = self.trans
        for c in pattern:
            nxt = trans[cur].get(c)
            if nxt is None:
                return -1
            cur = nxt
        return cur

    def contains(self, pattern: Sequence) -> bool:
        return self.walk(pattern) != -1

    def ids_for_pattern(self, pattern: Sequence) -> np.ndarray:
        """V_p — IDs of sequences containing ``pattern``."""
        st = self.walk(pattern)
        if st == -1:
            return np.empty(0, dtype=np.int64)
        return self.state_ids(st)

    def state_ids(self, state: int) -> np.ndarray:
        if self._ids_np is not None:
            return self._ids_np[state]
        return np.asarray(self.ids[state], dtype=np.int64)

    # ------------------------------------------------------------------ #
    # analysis / finalization
    # ------------------------------------------------------------------ #

    @property
    def num_states(self) -> int:
        return len(self.maxlen)

    @property
    def num_transitions(self) -> int:
        return sum(len(t) for t in self.trans)

    def total_id_entries(self) -> int:
        """Σ_states |V_state| — the O(m^1.5) quantity of Lemma 2."""
        return sum(len(x) for x in self.ids)

    def _invalidate(self) -> None:
        self._ids_np = None
        self._topo = None

    def finalize(self) -> None:
        """Freeze ID lists to NumPy and compute a topological order of the
        transition DAG (needed by the reverse-topo index build)."""
        self._ids_np = [np.asarray(x, dtype=np.int64) for x in self.ids]
        self._topo = self._topological_order()

    def _topological_order(self) -> np.ndarray:
        """Kahn's algorithm over transitions.  The automaton is a DAG because
        every transition strictly increases all positions (§4.1)."""
        n = self.num_states
        indeg = np.zeros(n, dtype=np.int64)
        for t in self.trans:
            for v in t.values():
                indeg[v] += 1
        order = np.empty(n, dtype=np.int64)
        head = 0
        tail = 0
        for u in range(n):
            if indeg[u] == 0:
                order[tail] = u
                tail += 1
        while head < tail:
            u = order[head]
            head += 1
            for v in self.trans[u].values():
                indeg[v] -= 1
                if indeg[v] == 0:
                    order[tail] = v
                    tail += 1
        if tail != n:  # pragma: no cover - structural invariant
            raise RuntimeError("ESAM transition graph has a cycle")
        return order

    def topo_order(self) -> np.ndarray:
        if self._topo is None:
            self._topo = self._topological_order()
        return self._topo

    # ------------------------------------------------------------------ #
    # serialization (checkpointing; DESIGN.md §5 fault tolerance)
    # ------------------------------------------------------------------ #

    def to_arrays(self) -> Dict[str, np.ndarray]:
        """Struct-of-arrays snapshot: transitions flattened to (src, sym, dst)
        triples with symbols interned, ID lists to a CSR pair."""
        symbols: List[object] = []
        sym_index: Dict[object, int] = {}
        src, sym, dst = [], [], []
        for u, t in enumerate(self.trans):
            for c, v in t.items():
                k = sym_index.get(c)
                if k is None:
                    k = len(symbols)
                    sym_index[c] = k
                    symbols.append(c)
                src.append(u)
                sym.append(k)
                dst.append(v)
        id_ptr = np.zeros(self.num_states + 1, dtype=np.int64)
        for u, lst in enumerate(self.ids):
            id_ptr[u + 1] = id_ptr[u] + len(lst)
        id_data = np.empty(int(id_ptr[-1]), dtype=np.int64)
        for u, lst in enumerate(self.ids):
            id_data[id_ptr[u]:id_ptr[u + 1]] = lst
        return {
            "maxlen": np.asarray(self.maxlen, dtype=np.int64),
            "link": np.asarray(self.link, dtype=np.int64),
            "trans_src": np.asarray(src, dtype=np.int64),
            "trans_sym": np.asarray(sym, dtype=np.int64),
            "trans_dst": np.asarray(dst, dtype=np.int64),
            "symbols": np.asarray([str(s) for s in symbols], dtype=object),
            "id_ptr": id_ptr,
            "id_data": id_data,
            "num_sequences": np.asarray([self.num_sequences], dtype=np.int64),
            "total_symbols": np.asarray([self.total_symbols], dtype=np.int64),
        }

    @classmethod
    def from_arrays(cls, arrays: Dict[str, np.ndarray]) -> "ESAM":
        self = cls.__new__(cls)
        maxlen = arrays["maxlen"]
        n = len(maxlen)
        self.maxlen = maxlen.tolist()
        self.link = arrays["link"].tolist()
        symbols = [str(s) for s in arrays["symbols"]]
        self.trans = [{} for _ in range(n)]
        for u, k, v in zip(arrays["trans_src"], arrays["trans_sym"],
                           arrays["trans_dst"]):
            self.trans[int(u)][symbols[int(k)]] = int(v)
        id_ptr, id_data = arrays["id_ptr"], arrays["id_data"]
        self.ids = [id_data[id_ptr[u]:id_ptr[u + 1]].tolist()
                    for u in range(n)]
        self.num_sequences = int(arrays["num_sequences"][0])
        self.total_symbols = int(arrays["total_symbols"][0])
        self._ids_np = None
        self._topo = None
        return self


# ---------------------------------------------------------------------- #
# Reference oracle (used by tests): brute-force poslist equivalence classes.
# ---------------------------------------------------------------------- #

def naive_equivalence_classes(
        seqs: Sequence[Sequence]) -> Dict[frozenset, List[Tuple]]:
    """Group every distinct substring of the collection by its poslist
    (Definitions 2-3).  Exponentially slower than ESAM; for tests only."""
    poslist: Dict[Tuple, set] = {}
    for sid, s in enumerate(seqs):
        n = len(s)
        for i in range(n):
            for j in range(i + 1, n + 1):
                p = tuple(s[i:j])
                poslist.setdefault(p, set()).add((sid, j - 1))
    classes: Dict[frozenset, List[Tuple]] = {}
    for p, pl in poslist.items():
        classes.setdefault(frozenset(pl), []).append(p)
    return classes


def naive_matching_ids(seqs: Sequence[Sequence], pattern: Sequence
                       ) -> np.ndarray:
    """V_p by direct substring scan; for tests only."""
    pat = tuple(pattern)
    L = len(pat)
    out = [sid for sid, s in enumerate(seqs)
           if any(tuple(s[i:i + L]) == pat for i in range(len(s) - L + 1))]
    return np.asarray(out, dtype=np.int64)
