# Copy of src/repro/core/predicate.py (no imports of repro).
# One edit: _fuse_scan_disjuncts names the device backend "torch" ("jax"
# there), so plans stay the reference's.
r"""Boolean pattern predicates — AST, parser, and plan compiler (DESIGN.md §3).

The paper motivates VectorMaton with SQL-style ``LIKE``/``CONTAINS``
predicates over sequence attributes; real filtered-ANNS workloads arrive as
*boolean combinations* of such predicates.  This module is the layer that
turns a predicate into something the packed executor can run:

  * **AST** — ``Contains``, ``Like`` (``%``/``_`` wildcards, ``\%``/
    ``\_`` escapes), structured attribute filters ``Tag(field, values)``
    and ``Range(field, lo, hi)``, plus ``And``, ``Or``, ``Not``; every
    node evaluates exactly on a host (sequence, attrs) record
    (``matches``), canonicalizes to a coalescing key (``key``), and
    renders back to parseable grammar text (``render``).
  * **Parser** — a tiny recursive-descent grammar over request strings:
    ``CONTAINS 'ab' AND NOT (cd OR LIKE 'a%b_')``, attribute comparisons
    ``genre = 'rock' AND price < 10``.  Quoted literals double embedded
    quotes SQL-style (``'it''s'``).  A string with no predicate syntax
    is a plain CONTAINS pattern, so every pre-existing request shape
    keeps working verbatim.
  * **Compiler** — lowers a predicate to a list of ``CompiledSource``
    disjuncts against a ``PackedRuntime``.  Each leaf resolves to an ESAM
    state cover (the chain of CSR base segments whose union is exactly
    V_state, Lemma 4) with selectivity taken from ``|V_state|``; boolean
    structure picks a per-source strategy:

      - ``chain``          — single CONTAINS: the legacy raw+graph chain.
      - ``scan``           — segmented brute-force over an explicit id set
                             (Or-unions deduped via a membership bitmap,
                             low-selectivity And intersections, Not
                             complements).
      - ``filtered_graph`` — beam search over the smallest conjunct's
                             graphs consulting a composed candidate bitmap
                             in-loop, for high-selectivity conjunctions.
      - ``residual``       — automaton prefilter + exact host-side
                             verification with an over-fetch loop, for
                             multi-segment ``LIKE '%a%b%'`` (the automaton
                             can only prefilter it as ``a AND b``) and
                             negated LIKE.

The compiler never consults per-state Python index objects — only the
packed CSR/inherit arrays — so compiled predicates are pure plan data, the
same contract plan entries already obey.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "Predicate", "Contains", "Like", "Tag", "Range", "And", "Or", "Not",
    "PredicateSyntaxError", "parse_predicate", "as_predicate",
    "quote_literal",
    "CompiledSource", "CompiledPredicate", "compile_predicate",
]

# Strategy thresholds: a conjunction whose anchor chain owns graph states
# only uses them when the composed mask keeps enough of the anchor alive
# for beam search to navigate (the filtered-ANNS survey's flip point).
FILTERED_GRAPH_MIN_KEEP = 64        # absolute floor on surviving candidates
FILTERED_GRAPH_MIN_FRAC = 0.25      # fraction of the anchor cover surviving


# ===================================================================== #
# AST
# ===================================================================== #

def quote_literal(text: str) -> str:
    """Quote ``text`` for the predicate grammar: embedded quotes double
    SQL-style, so any literal — spaces, keywords, parens, operators,
    quotes — round-trips through the tokenizer."""
    return "'" + str(text).replace("'", "''") + "'"


class Predicate:
    """Base class.  Subclasses are immutable value objects."""

    def key(self) -> str:
        raise NotImplementedError

    def matches(self, seq, attrs=None) -> bool:
        """Exact host-side evaluation against one record: its sequence
        plus (for attribute nodes) its attribute dict."""
        raise NotImplementedError

    def render(self) -> str:
        """Grammar text that reparses to an equal-``key()`` predicate."""
        raise NotImplementedError

    # sugar so tests/examples can compose: a & b, a | b, ~a
    def __and__(self, other: "Predicate") -> "And":
        return And([self, other])

    def __or__(self, other: "Predicate") -> "Or":
        return Or([self, other])

    def __invert__(self) -> "Not":
        return Not(self)

    def __eq__(self, other) -> bool:
        return isinstance(other, Predicate) and self.key() == other.key()

    def __hash__(self) -> int:
        return hash(self.key())

    def __repr__(self) -> str:
        return self.key()


class Contains(Predicate):
    """Substring containment — the paper's single-pattern predicate."""

    def __init__(self, pattern) -> None:
        self.pattern = pattern if isinstance(pattern, str) else tuple(pattern)

    def key(self) -> str:
        return f"CONTAINS({self.pattern!r})"

    def render(self) -> str:
        if not isinstance(self.pattern, str):
            raise TypeError("only string CONTAINS patterns render")
        return f"CONTAINS {quote_literal(self.pattern)}"

    def matches(self, seq, attrs=None) -> bool:
        if isinstance(self.pattern, str) and isinstance(seq, str):
            return self.pattern in seq
        pat = tuple(self.pattern)
        s = tuple(seq)
        L = len(pat)
        if L == 0:
            return True
        return any(s[i:i + L] == pat for i in range(len(s) - L + 1))


class Like(Predicate):
    """SQL LIKE over the whole sequence: ``%`` = any run (incl. empty),
    ``_`` = exactly one symbol.  A backslash escapes the next character,
    so ``\\%`` / ``\\_`` / ``\\\\`` match the literal ``%`` / ``_`` /
    ``\\``.  The pattern is parsed ONCE into wildcard/literal tokens;
    ``regex``, ``literals``, and ``as_contains`` all derive from the
    same token list so the escape rules cannot drift.  String sequences
    only."""

    def __init__(self, pattern: str) -> None:
        if not isinstance(pattern, str):
            raise TypeError("LIKE patterns must be strings")
        self.pattern = pattern
        self._toks: Optional[List[Tuple[str, str]]] = None

    def key(self) -> str:
        return f"LIKE({self.pattern!r})"

    def render(self) -> str:
        return f"LIKE {quote_literal(self.pattern)}"

    def tokens(self) -> List[Tuple[str, str]]:
        """[('any'|'one'|'lit', char)] — the escape-resolved pattern.  A
        trailing lone backslash is the literal backslash."""
        if self._toks is None:
            toks: List[Tuple[str, str]] = []
            p, i = self.pattern, 0
            while i < len(p):
                c = p[i]
                if c == "\\" and i + 1 < len(p):
                    toks.append(("lit", p[i + 1]))
                    i += 2
                elif c == "%":
                    toks.append(("any", c))
                    i += 1
                elif c == "_":
                    toks.append(("one", c))
                    i += 1
                else:
                    toks.append(("lit", c))
                    i += 1
            self._toks = toks
        return self._toks

    def regex(self) -> "re.Pattern":
        parts = []
        for kind, ch in self.tokens():
            if kind == "any":
                parts.append(".*")
            elif kind == "one":
                parts.append(".")
            else:
                parts.append(re.escape(ch))
        return re.compile("".join(parts), re.DOTALL)

    def matches(self, seq, attrs=None) -> bool:
        if not isinstance(seq, str):
            raise TypeError("LIKE predicates require string sequences")
        return self.regex().fullmatch(seq) is not None

    def literals(self) -> List[str]:
        """Maximal wildcard-free runs — each is a necessary CONTAINS.
        Escaped wildcard characters are ordinary literal characters and
        join their surrounding run."""
        out: List[str] = []
        cur: List[str] = []
        for kind, ch in self.tokens():
            if kind == "lit":
                cur.append(ch)
            elif cur:
                out.append("".join(cur))
                cur = []
        if cur:
            out.append("".join(cur))
        return out

    def as_contains(self) -> Optional[Contains]:
        """``%lit%`` (no ``_``) is exactly CONTAINS(lit); bare ``%`` runs
        are the empty pattern (match-all).  ``LIKE ''`` is NOT rewritable
        (it matches only the empty sequence) and neither is an escaped
        pattern like ``\\%`` — a literal-only pattern anchors both ends,
        so it stays residual rather than collapsing to match-all."""
        toks = self.tokens()
        if not toks:
            return None
        if all(kind == "any" for kind, _ in toks):
            return Contains("")
        i, j = 0, len(toks)
        while i < j and toks[i][0] == "any":
            i += 1
        while j > i and toks[j - 1][0] == "any":
            j -= 1
        if i == 0 or j == len(toks):          # not %-wrapped on both sides
            return None
        mid = toks[i:j]
        if all(kind == "lit" for kind, _ in mid):
            return Contains("".join(ch for _, ch in mid))
        return None


class Tag(Predicate):
    """Categorical attribute filter: ``attrs[field] ∈ values``.  Values
    compare as strings (the schema's ``tag`` type).  Parsed from
    ``field = 'value'``; multi-value tags compose/parse as OR."""

    def __init__(self, field: str, values) -> None:
        vals = (values,) if isinstance(values, str) else tuple(values)
        self.field = str(field)
        self.values = tuple(sorted(str(v) for v in vals))
        if not self.values:
            raise ValueError("Tag needs at least one value")

    def key(self) -> str:
        return f"TAG({self.field!r},{self.values!r})"

    def render(self) -> str:
        parts = [f"{self.field} = {quote_literal(v)}" for v in self.values]
        return parts[0] if len(parts) == 1 else "(" + " OR ".join(parts) + ")"

    def matches(self, seq, attrs=None) -> bool:
        if attrs is None:
            raise ValueError(
                f"attribute predicate {self.key()} needs the record's "
                f"attribute dict (matches(seq, attrs))")
        v = attrs.get(self.field)
        return v is not None and str(v) in self.values


class Range(Predicate):
    """Numeric attribute filter: ``lo <(=) attrs[field] <(=) hi`` with
    either bound optional.  Parsed from ``field < 10`` / ``field >= 2`` /
    ``field = 3`` (equality is the degenerate closed range)."""

    def __init__(self, field: str, lo=None, hi=None,
                 incl_lo: bool = True, incl_hi: bool = True) -> None:
        self.field = str(field)
        self.lo = None if lo is None else float(lo)
        self.hi = None if hi is None else float(hi)
        self.incl_lo = bool(incl_lo)
        self.incl_hi = bool(incl_hi)
        if self.lo is None and self.hi is None:
            raise ValueError("Range needs at least one bound")

    def key(self) -> str:
        return (f"RANGE({self.field!r},{self.lo!r},{self.hi!r},"
                f"{int(self.incl_lo)},{int(self.incl_hi)})")

    def render(self) -> str:
        f = self.field
        if self.lo is not None and self.hi is not None:
            if self.lo == self.hi and self.incl_lo and self.incl_hi:
                return f"{f} = {self.lo!r}"
            lo_op = ">=" if self.incl_lo else ">"
            hi_op = "<=" if self.incl_hi else "<"
            return (f"({f} {lo_op} {self.lo!r} AND {f} {hi_op} "
                    f"{self.hi!r})")
        if self.lo is not None:
            return f"{f} {'>=' if self.incl_lo else '>'} {self.lo!r}"
        return f"{f} {'<=' if self.incl_hi else '<'} {self.hi!r}"

    def matches(self, seq, attrs=None) -> bool:
        if attrs is None:
            raise ValueError(
                f"attribute predicate {self.key()} needs the record's "
                f"attribute dict (matches(seq, attrs))")
        v = attrs.get(self.field)
        if v is None or isinstance(v, bool):
            return False
        try:
            x = float(v)
        except (TypeError, ValueError):
            return False
        if self.lo is not None and (x < self.lo or
                                    (x == self.lo and not self.incl_lo)):
            return False
        if self.hi is not None and (x > self.hi or
                                    (x == self.hi and not self.incl_hi)):
            return False
        return True


class And(Predicate):
    def __init__(self, children: Sequence[Predicate]) -> None:
        self.children = list(children)

    def key(self) -> str:
        return "AND(" + ",".join(c.key() for c in self.children) + ")"

    def render(self) -> str:
        return "(" + " AND ".join(c.render() for c in self.children) + ")"

    def matches(self, seq, attrs=None) -> bool:
        return all(c.matches(seq, attrs) for c in self.children)


class Or(Predicate):
    def __init__(self, children: Sequence[Predicate]) -> None:
        self.children = list(children)

    def key(self) -> str:
        return "OR(" + ",".join(c.key() for c in self.children) + ")"

    def render(self) -> str:
        return "(" + " OR ".join(c.render() for c in self.children) + ")"

    def matches(self, seq, attrs=None) -> bool:
        return any(c.matches(seq, attrs) for c in self.children)


class Not(Predicate):
    def __init__(self, child: Predicate) -> None:
        self.child = child

    def key(self) -> str:
        return f"NOT({self.child.key()})"

    def render(self) -> str:
        return f"NOT {self.child.render()}"

    def matches(self, seq, attrs=None) -> bool:
        return not self.child.matches(seq, attrs)


# ===================================================================== #
# parser
# ===================================================================== #

class PredicateSyntaxError(ValueError):
    pass


_KEYWORDS = {"AND", "OR", "NOT", "LIKE", "CONTAINS"}


def _tokenize(text: str) -> List[Tuple[str, str]]:
    """[(kind, value)] with kind in {kw, lit, qlit, lparen, rparen, op}.

    ``qlit`` is a quoted literal — embedded quotes double SQL-style
    (``'it''s'`` is the literal ``it's``), so any character sequence is
    expressible.  ``op`` is a comparison operator (= != < <= > >=); a
    bare ``!`` stays part of a word."""
    toks: List[Tuple[str, str]] = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c.isspace():
            i += 1
        elif c == "(":
            toks.append(("lparen", c))
            i += 1
        elif c == ")":
            toks.append(("rparen", c))
            i += 1
        elif c == "'":
            j = i + 1
            buf: List[str] = []
            while True:
                nxt = text.find("'", j)
                if nxt < 0:
                    raise PredicateSyntaxError(f"unterminated quote at {i}")
                if nxt + 1 < n and text[nxt + 1] == "'":
                    buf.append(text[j:nxt + 1])   # keep ONE of the pair
                    j = nxt + 2
                else:
                    buf.append(text[j:nxt])
                    j = nxt + 1
                    break
            toks.append(("qlit", "".join(buf)))
            i = j
        elif c in "=<>":
            if c in "<>" and i + 1 < n and text[i + 1] == "=":
                toks.append(("op", c + "="))
                i += 2
            else:
                toks.append(("op", c))
                i += 1
        elif c == "!" and i + 1 < n and text[i + 1] == "=":
            toks.append(("op", "!="))
            i += 2
        else:
            j = i
            while (j < n and not text[j].isspace()
                   and text[j] not in "()'=<>"
                   and not (text[j] == "!" and j + 1 < n
                            and text[j + 1] == "=")):
                j += 1
            word = text[i:j]
            toks.append(("kw", word) if word in _KEYWORDS else ("lit", word))
            i = j
    return toks


class _Parser:
    def __init__(self, toks: List[Tuple[str, str]]) -> None:
        self.toks = toks
        self.pos = 0

    def peek(self) -> Optional[Tuple[str, str]]:
        return self.toks[self.pos] if self.pos < len(self.toks) else None

    def take(self) -> Tuple[str, str]:
        if self.pos >= len(self.toks):
            raise PredicateSyntaxError("unexpected end of predicate")
        t = self.toks[self.pos]
        self.pos += 1
        return t

    def expr(self) -> Predicate:
        node = self.term()
        children = [node]
        while self.peek() == ("kw", "OR"):
            self.take()
            children.append(self.term())
        return children[0] if len(children) == 1 else Or(children)

    def term(self) -> Predicate:
        node = self.factor()
        children = [node]
        while self.peek() == ("kw", "AND"):
            self.take()
            children.append(self.factor())
        return children[0] if len(children) == 1 else And(children)

    def factor(self) -> Predicate:
        if self.peek() == ("kw", "NOT"):
            self.take()
            return Not(self.factor())
        return self.atom()

    def atom(self) -> Predicate:
        kind, val = self.take()
        if kind == "lparen":
            node = self.expr()
            if self.take()[0] != "rparen":
                raise PredicateSyntaxError("expected ')'")
            return node
        if kind == "kw" and val == "LIKE":
            k2, v2 = self.take()
            if k2 not in ("lit", "qlit"):
                raise PredicateSyntaxError("LIKE expects a pattern literal")
            return Like(v2)
        if kind == "kw" and val == "CONTAINS":
            k2, v2 = self.take()
            if k2 not in ("lit", "qlit"):
                raise PredicateSyntaxError(
                    "CONTAINS expects a pattern literal")
            return Contains(v2)
        if kind == "lit" and self.peek() is not None \
                and self.peek()[0] == "op":
            _, op = self.take()
            k2, v2 = self.take()
            if k2 not in ("lit", "qlit"):
                raise PredicateSyntaxError(
                    f"comparison '{val} {op}' expects a value literal")
            return _comparison(val, op, v2, quoted=(k2 == "qlit"))
        if kind in ("lit", "qlit"):
            return Contains(val)
        raise PredicateSyntaxError(f"unexpected token {val!r}")


def _comparison(field: str, op: str, value: str, quoted: bool) -> Predicate:
    """``field op value`` → a Tag/Range leaf.  A quoted RHS is always a
    tag value; an unquoted RHS that parses as a number is numeric."""
    num: Optional[float] = None
    if not quoted:
        try:
            num = float(value)
        except ValueError:
            num = None
    if op in ("<", "<=", ">", ">="):
        if num is None:
            raise PredicateSyntaxError(
                f"'{field} {op} {value}' needs a numeric literal "
                f"(quote tag values and compare with = / !=)")
        if op == "<":
            return Range(field, None, num, incl_hi=False)
        if op == "<=":
            return Range(field, None, num, incl_hi=True)
        if op == ">":
            return Range(field, num, None, incl_lo=False)
        return Range(field, num, None, incl_lo=True)
    node: Predicate = (Range(field, num, num) if num is not None
                       else Tag(field, (value,)))
    return node if op == "=" else Not(node)


_QUOTING_HINT = (
    "quote literal patterns containing grammar characters (quotes, "
    "parentheses, comparison operators, or standalone uppercase "
    "keywords), e.g. CONTAINS 'a(b' — write a literal quote by "
    "doubling it: 'it''s'")


def parse_predicate(text: str) -> Predicate:
    """Parse a request string.  Strings containing no predicate syntax
    (no uppercase keyword, quote, parenthesis, or comparison operator)
    are CONTAINS patterns taken verbatim — the pre-predicate request
    shape.  A literal pattern that happens to contain grammar characters
    must be quoted (``CONTAINS 'NOT A DRILL'``) or passed as
    ``Contains(...)``; both parentheses are treated symmetrically."""
    if not isinstance(text, str):
        return Contains(text)
    if not (any(k in text for k in _KEYWORDS) or "'" in text
            or "(" in text or ")" in text
            or "=" in text or "<" in text or ">" in text):
        return Contains(text)
    toks = _tokenize(text)
    # Keyword substrings inside ordinary words ("bAND cd") tokenize to
    # plain lits: still a verbatim CONTAINS.  Any real grammar token —
    # keyword, EITHER paren, operator — or a quote means the string must
    # parse as a predicate (or be quoted by the caller).
    if not any(k in ("kw", "op", "lparen", "rparen") for k, _ in toks) \
            and "'" not in text:
        return Contains(text)
    p = _Parser(toks)
    try:
        node = p.expr()
        if p.peek() is not None:
            raise PredicateSyntaxError(
                f"trailing tokens after predicate: {p.toks[p.pos:]}")
    except PredicateSyntaxError as e:
        raise PredicateSyntaxError(f"{e}; {_QUOTING_HINT}") from None
    return node


def as_predicate(pattern) -> Predicate:
    """Request shapes accepted everywhere: Predicate objects pass through,
    strings go through the parser, any other sequence is CONTAINS."""
    if isinstance(pattern, Predicate):
        return pattern
    if isinstance(pattern, str):
        return parse_predicate(pattern)
    return Contains(pattern)


# ===================================================================== #
# normalization
# ===================================================================== #

def _rewrite_like(p: Predicate) -> Predicate:
    """LIKE patterns equivalent to CONTAINS lose their residual."""
    if isinstance(p, Like):
        c = p.as_contains()
        return c if c is not None else p
    if isinstance(p, And):
        return And([_rewrite_like(c) for c in p.children])
    if isinstance(p, Or):
        return Or([_rewrite_like(c) for c in p.children])
    if isinstance(p, Not):
        return Not(_rewrite_like(p.child))
    return p


def _nnf(p: Predicate, neg: bool = False) -> Predicate:
    """Negation normal form: NOT pushed onto leaves (De Morgan)."""
    if isinstance(p, Not):
        return _nnf(p.child, not neg)
    if isinstance(p, And):
        ch = [_nnf(c, neg) for c in p.children]
        return Or(ch) if neg else And(ch)
    if isinstance(p, Or):
        ch = [_nnf(c, neg) for c in p.children]
        return And(ch) if neg else Or(ch)
    return Not(p) if neg else p


def _merge_range_conjuncts(ch: List[Predicate]) -> List[Predicate]:
    """Same-field Range conjuncts intersect into one leaf, so a two-sided
    comparison (``price >= 3 AND price <= 12``) compiles to a single rank
    window over the attribute segment (descriptor execution) instead of a
    masked scan.  A contradictory intersection yields an inverted-interval
    Range that matches nothing — the compiler drops it as empty."""
    by_field: Dict[str, List[Range]] = {}
    rest: List[Predicate] = []
    for c in ch:
        if isinstance(c, Range):
            by_field.setdefault(c.field, []).append(c)
        else:
            rest.append(c)
    for f, rs in by_field.items():
        if len(rs) == 1:
            rest.append(rs[0])
            continue
        lo, incl_lo, hi, incl_hi = None, True, None, True
        for r in rs:
            if r.lo is not None and (lo is None or r.lo > lo or
                                     (r.lo == lo and not r.incl_lo)):
                lo, incl_lo = r.lo, r.incl_lo
            if r.hi is not None and (hi is None or r.hi < hi or
                                     (r.hi == hi and not r.incl_hi)):
                hi, incl_hi = r.hi, r.incl_hi
        rest.append(Range(f, lo, hi, incl_lo, incl_hi))
    return rest


def _flatten(p: Predicate) -> Predicate:
    """And(And(..)) / Or(Or(..)) collapse; single-child nodes unwrap."""
    if isinstance(p, And):
        ch: List[Predicate] = []
        for c in (_flatten(c) for c in p.children):
            ch.extend(c.children if isinstance(c, And) else [c])
        ch = _merge_range_conjuncts(ch)
        return ch[0] if len(ch) == 1 else And(ch)
    if isinstance(p, Or):
        ch = []
        for c in (_flatten(c) for c in p.children):
            ch.extend(c.children if isinstance(c, Or) else [c])
        return ch[0] if len(ch) == 1 else Or(ch)
    if isinstance(p, Not):
        return Not(_flatten(p.child))
    return p


def normalize(p: Predicate) -> Predicate:
    return _flatten(_nnf(_rewrite_like(p)))


# ===================================================================== #
# compiled representation
# ===================================================================== #

@dataclass
class CompiledSource:
    """One disjunct of a compiled predicate — what the executor runs."""
    strategy: str                                # chain|scan|filtered_graph|residual
    anchor: int = -1                             # anchor state (chain-backed)
    segments: List[Tuple[int, int]] = field(default_factory=list)
    seg_states: List[int] = field(default_factory=list)  # chain state per
                                                 # segment (sharded CSR key)
    raw_segments: List[Tuple[int, int]] = field(default_factory=list)
    graph_states: List[int] = field(default_factory=list)
    ids: Optional[np.ndarray] = None             # explicit candidate ids
    allowed: Optional[np.ndarray] = None         # (n,) composed conjunct mask
    verify: Optional[Predicate] = None           # residual host check
    est: int = 0                                 # estimated |result|
    delta_ids: Optional[np.ndarray] = None       # post-freeze inserts to
                                                 # brute-force alongside the
                                                 # frozen cover (write path)
    attr_ranges: List[Tuple[int, int, int]] = field(default_factory=list)
                                                 # (pseudo_state, rank_lo,
                                                 # rank_hi): a PARTIAL slice
                                                 # of an attribute segment —
                                                 # the sharded planner turns
                                                 # it into per-shard
                                                 # descriptor columns
    residual_full: bool = False                  # residual sources: start the
                                                 # over-fetch loop at the full
                                                 # prefilter (a measured yield
                                                 # collapse replayed by the
                                                 # adaptive planner, §11)


@dataclass
class CompiledPredicate:
    key: str
    pred: Predicate
    sources: List[CompiledSource]
    est: int

    @property
    def empty(self) -> bool:
        """Provably no sequence qualifies (pattern ∉ corpus, etc.)."""
        return not self.sources


# ===================================================================== #
# compiler
# ===================================================================== #

class _Ctx:
    """Per-compile scratch: cover/mask lookups against the packed CSR plus
    the generation's delta (DESIGN.md §4).  Freeze-time states resolve to
    frozen chain cover ∪ chain-delta; states created after the freeze
    have no frozen cover and resolve to their live ESAM V set."""

    def __init__(self, esam, runtime, planner=None) -> None:
        self.esam = esam
        self.rt = runtime
        self.n = len(runtime.vectors)            # live count: base + delta
        self.n_frozen = runtime.n_states
        self.planner = planner                   # AdaptivePlanner | None —
                                                 # None/static keeps every
                                                 # legacy decision (parity
                                                 # oracle, DESIGN.md §11)
        self._mask_cache: Dict[int, np.ndarray] = {}
        self._delta_cache: Dict[int, np.ndarray] = {}
        self._attr_mask_cache: Dict[str, np.ndarray] = {}

    def walk(self, pattern) -> int:
        return self.esam.walk(pattern)

    def cover(self, state: int):
        return self.rt.chain_cover(state)

    def delta_ids(self, state: int) -> np.ndarray:
        """Brute-force top-up for ``state``: post-freeze ids on its frozen
        chain, or the whole live V set for post-freeze states."""
        d = self._delta_cache.get(state)
        if d is None:
            if state < self.n_frozen:
                d = self.rt.chain_delta_ids(state)
            else:
                d = np.asarray(self.esam.state_ids(state), dtype=np.int64)
            self._delta_cache[state] = d
        return d

    def cover_size(self, state: int) -> int:
        if state < self.n_frozen:
            return self.cover(state).size + len(self.delta_ids(state))
        return len(self.delta_ids(state))

    def cover_mask(self, state: int) -> np.ndarray:
        m = self._mask_cache.get(state)
        if m is None:
            m = np.zeros(self.n, dtype=bool)
            if state < self.n_frozen:
                m[self.rt.chain_ids(state)] = True
            m[self.delta_ids(state)] = True
            self._mask_cache[state] = m
        return m

    # -------------------------------------------------------------- #
    # attribute leaves (Tag / Range) against the frozen per-attribute
    # sorted-ID segments (PackedRuntime.attr_num / attr_tag) plus the
    # live delta tail
    # -------------------------------------------------------------- #
    def attr_field(self, node) -> str:
        schema = getattr(self.rt, "attr_schema", None) or {}
        want = "tag" if isinstance(node, Tag) else "numeric"
        if not schema:
            raise ValueError(
                f"attribute predicate {node.key()} needs a typed schema: "
                f"declare the field in VectorMatonConfig.schema")
        got = schema.get(node.field)
        if got is None:
            raise ValueError(
                f"unknown attribute field {node.field!r}: declare it in "
                f"VectorMatonConfig.schema (have {sorted(schema)})")
        if got != want:
            raise ValueError(
                f"attribute field {node.field!r} is typed {got!r} in the "
                f"schema but the predicate uses it as {want!r}")
        return node.field

    def attr_segments(self, node) -> Tuple[
            List[Tuple[int, int]], List[int],
            List[Tuple[int, int, int]], int]:
        """Frozen lowering of one attribute leaf: (global CSR segments,
        full pseudo-states, partial (state, rank_lo, rank_hi) ranges,
        frozen member count)."""
        field_name = self.attr_field(node)
        ptr = self.rt.base_ptr
        if isinstance(node, Tag):
            tmap = getattr(self.rt, "attr_tag", {}).get(field_name, {})
            segs, states = [], []
            for v in node.values:
                u = tmap.get(v)
                if u is None:
                    continue
                lo, hi = int(ptr[u]), int(ptr[u + 1])
                if hi > lo:
                    segs.append((lo, hi))
                    states.append(u)
            return segs, states, [], sum(h - l for l, h in segs)
        u, vals = getattr(self.rt, "attr_num", {}).get(
            field_name, (None, None))
        if u is None:
            return [], [], [], 0
        a = (0 if node.lo is None else int(np.searchsorted(
            vals, node.lo, side="left" if node.incl_lo else "right")))
        b = (len(vals) if node.hi is None else int(np.searchsorted(
            vals, node.hi, side="right" if node.incl_hi else "left")))
        if b <= a:
            return [], [], [], 0
        lo, hi = int(ptr[u]) + a, int(ptr[u]) + b
        return [(lo, hi)], [], [(int(u), a, b)], b - a

    def attr_delta_ids(self, node) -> np.ndarray:
        """Post-freeze inserts whose attributes satisfy the leaf."""
        attrs = getattr(self.rt, "attributes", None) or []
        n0 = self.rt.delta.n_base
        out = [i for i in range(n0, self.n)
               if node.matches(None, attrs[i] if i < len(attrs) else {})]
        return np.asarray(out, dtype=np.int64)

    def attr_mask(self, node) -> np.ndarray:
        key = node.key()
        m = self._attr_mask_cache.get(key)
        if m is None:
            segs, _, _, _ = self.attr_segments(node)
            m = np.zeros(self.n, dtype=bool)
            for lo, hi in segs:
                m[self.rt.base_ids[lo:hi]] = True
            m[self.attr_delta_ids(node)] = True
            self._attr_mask_cache[key] = m
        return m


def _node_mask(node: Predicate, ctx: _Ctx) -> Tuple[np.ndarray, bool]:
    """(superset mask of the node's members, exact?).  The mask is always a
    *superset* of the true member set; ``exact`` marks it tight.  NNF input
    (Not only wraps leaves)."""
    if isinstance(node, Contains):
        st = ctx.walk(node.pattern)
        if st == -1:
            return np.zeros(ctx.n, dtype=bool), True
        return ctx.cover_mask(st), True
    if isinstance(node, Like):
        lits = node.literals()
        if not lits:
            return np.ones(ctx.n, dtype=bool), False
        m = None
        for lit in lits:
            st = ctx.walk(lit)
            if st == -1:                      # necessary literal absent
                return np.zeros(ctx.n, dtype=bool), True
            lm = ctx.cover_mask(st)
            m = lm.copy() if m is None else (m & lm)
        return m, False
    if isinstance(node, (Tag, Range)):
        return ctx.attr_mask(node), True
    if isinstance(node, Not):
        m, exact = _node_mask(node.child, ctx)
        if exact:
            return ~m, True
        # complement of a superset is not a superset — fall back to all
        return np.ones(ctx.n, dtype=bool), False
    if isinstance(node, And):
        m = np.ones(ctx.n, dtype=bool)
        exact = True
        for c in node.children:
            cm, ce = _node_mask(c, ctx)
            m &= cm
            exact &= ce
        return m, exact
    if isinstance(node, Or):
        m = np.zeros(ctx.n, dtype=bool)
        exact = True
        for c in node.children:
            cm, ce = _node_mask(c, ctx)
            m |= cm
            exact &= ce
        return m, exact
    raise TypeError(f"unknown predicate node {node!r}")


def _contains_source(node: Contains, ctx: _Ctx) -> Optional[CompiledSource]:
    st = ctx.walk(node.pattern)
    if st == -1:
        return None
    delta = ctx.delta_ids(st)
    if st >= ctx.n_frozen:
        # state born after the generation froze: no frozen cover — its
        # live V set (which may include pre-freeze ids copied by a clone
        # split) is brute-forced as an explicit scan
        if len(delta) == 0:
            return None
        return CompiledSource(strategy="scan", anchor=st, ids=delta,
                              est=len(delta))
    cov = ctx.cover(st)
    return CompiledSource(strategy="chain", anchor=st,
                          segments=cov.segments,
                          seg_states=cov.states,
                          raw_segments=cov.raw_segments,
                          graph_states=cov.graph_states,
                          delta_ids=delta if len(delta) else None,
                          est=cov.size + len(delta))


def _mask_scan_source(mask: np.ndarray, exact: bool,
                      node: Predicate) -> Optional[CompiledSource]:
    ids = np.nonzero(mask)[0].astype(np.int64)
    if len(ids) == 0:
        return None
    if exact:
        return CompiledSource(strategy="scan", ids=ids, est=len(ids))
    return CompiledSource(strategy="residual", ids=ids, verify=node,
                          est=len(ids))


def _and_source(node: And, ctx: _Ctx) -> Optional[CompiledSource]:
    """Pick the smallest positive-CONTAINS conjunct as the anchor, compose
    the remaining conjuncts into a membership mask, and choose scan vs
    filtered-graph by surviving selectivity."""
    anchors: List[Tuple[int, int, int]] = []     # (|cover|, child idx, state)
    for i, c in enumerate(node.children):
        if isinstance(c, Contains):
            st = ctx.walk(c.pattern)
            if st == -1:
                return None                       # conjunction provably empty
            anchors.append((ctx.cover_size(st), i, st))
    if not anchors:
        mask, exact = _node_mask(node, ctx)
        return _mask_scan_source(mask, exact, node)
    anchors.sort()
    _, anchor_idx, anchor_state = anchors[0]
    frozen = anchor_state < ctx.n_frozen
    cov = ctx.cover(anchor_state) if frozen else None
    allowed = np.ones(ctx.n, dtype=bool)
    exact = True
    for i, c in enumerate(node.children):
        if i == anchor_idx:
            continue
        cm, ce = _node_mask(c, ctx)
        allowed &= cm
        exact &= ce
    anchor_base = (ctx.rt.chain_ids(anchor_state) if frozen
                   else np.empty(0, np.int64))
    anchor_delta = ctx.delta_ids(anchor_state)
    keep_base = allowed[anchor_base]
    # delta ids verified against the composed mask host-side here — they
    # are brute-forced regardless of the strategy chosen below
    delta_kept = np.sort(anchor_delta[allowed[anchor_delta]])
    sel = int(keep_base.sum()) + len(delta_kept)
    planner = ctx.planner
    if planner is not None and planner.adaptive:
        # estimates-vs-observed bookkeeping: the interval the estimator
        # would have scored with, checked against the exact count the
        # compile materialized anyway (planner_est_* counters)
        planner.record_estimate(planner.estimator.estimate(node, ctx), sel)
    if sel == 0 and exact:
        return None
    if not exact:
        ids = np.sort(np.concatenate([anchor_base[keep_base], delta_kept]))
        if len(ids) == 0:
            return None
        return CompiledSource(strategy="residual", anchor=anchor_state,
                              ids=ids, verify=node, est=sel)
    # legacy compile-time rule — the static parity oracle, and the upper
    # bound of the adaptive planner's legal set (beam recall is part of
    # the static contract: adaptive may demote filtered_graph -> scan on
    # measured cost, never promote a scan into a beam search)
    static_strategy = ("filtered_graph"
                       if frozen and cov.graph_states and sel >= max(
                           FILTERED_GRAPH_MIN_KEEP,
                           int(FILTERED_GRAPH_MIN_FRAC
                               * ctx.cover_size(anchor_state)))
                       else "scan")
    strategy = static_strategy
    if planner is not None:
        strategy = planner.choose_conjunction(
            key=node.key(), version=int(ctx.rt.delta.version), sel=sel,
            n_graphs=len(cov.graph_states) if cov is not None else 0,
            static_strategy=static_strategy)
    if strategy == "filtered_graph":
        return CompiledSource(strategy="filtered_graph", anchor=anchor_state,
                              segments=cov.segments,
                              seg_states=cov.states,
                              raw_segments=cov.raw_segments,
                              graph_states=cov.graph_states,
                              allowed=allowed, est=sel,
                              delta_ids=(delta_kept if len(delta_kept)
                                         else None))
    return CompiledSource(
        strategy="scan", anchor=anchor_state,
        ids=np.sort(np.concatenate([anchor_base[keep_base], delta_kept])),
        est=sel)


def _like_source(node: Like, ctx: _Ctx) -> Optional[CompiledSource]:
    lits = node.literals()
    if not lits:
        return CompiledSource(strategy="residual",
                              ids=np.arange(ctx.n, dtype=np.int64),
                              verify=node, est=ctx.n)
    best_state, best_size = -1, -1
    mask = None
    for lit in lits:
        st = ctx.walk(lit)
        if st == -1:
            return None
        size = ctx.cover_size(st)
        if best_state == -1 or size < best_size:
            best_state, best_size = st, size
        lm = ctx.cover_mask(st)
        mask = lm.copy() if mask is None else (mask & lm)
    ids = np.nonzero(mask)[0].astype(np.int64)
    if len(ids) == 0:
        return None
    return CompiledSource(strategy="residual", anchor=best_state, ids=ids,
                          verify=node, est=len(ids))


def _attr_source(node: Predicate, ctx: _Ctx) -> Optional[CompiledSource]:
    """A bare Tag/Range disjunct rides the chain machinery: its frozen
    members are contiguous slices of the per-attribute sorted-ID segments
    in the resident CSR, so the warm path executes as (seg_start,
    seg_len, owner) descriptors with ZERO candidate-id upload — a Range
    is a single rank slice of one pseudo-state, a Tag is one full
    pseudo-state segment per value.  Post-freeze inserts join as a
    brute-forced delta tail, same as chain covers."""
    segs, states, ranges, frozen_size = ctx.attr_segments(node)
    delta = ctx.attr_delta_ids(node)
    if frozen_size + len(delta) == 0:
        return None
    return CompiledSource(strategy="chain", anchor=-1,
                          segments=segs, seg_states=states,
                          raw_segments=segs, attr_ranges=ranges,
                          delta_ids=delta if len(delta) else None,
                          est=frozen_size + len(delta))


def _compile_disjunct(node: Predicate, ctx: _Ctx
                      ) -> Optional[CompiledSource]:
    if isinstance(node, Contains):
        return _contains_source(node, ctx)
    if isinstance(node, Like):
        return _like_source(node, ctx)
    if isinstance(node, (Tag, Range)):
        return _attr_source(node, ctx)
    if isinstance(node, And):
        return _and_source(node, ctx)
    if isinstance(node, Not):
        mask, exact = _node_mask(node, ctx)
        return _mask_scan_source(mask, exact, node)
    if isinstance(node, Or):                       # nested Or after flatten
        mask, exact = _node_mask(node, ctx)
        return _mask_scan_source(mask, exact, node)
    raise TypeError(f"unknown predicate node {node!r}")


def compile_predicate(pred: Predicate, esam, runtime,
                      planner=None) -> CompiledPredicate:
    """Lower ``pred`` to executable sources against a PackedRuntime.

    Top-level OR splits into one source per disjunct; the executor merges
    their results with id-dedup (a membership-bitmap union collapses pure
    scan disjuncts into one deduplicated scan first).  Residual sources
    require the runtime to carry the original sequences.

    ``planner`` (core.planner.AdaptivePlanner) arbitrates strategy for
    conjunction sources and replays measured residual escalations; None
    or ``plan_mode="static"`` reproduces every legacy decision exactly
    (DESIGN.md §11)."""
    pred = as_predicate(pred)
    norm = normalize(pred)
    ctx = _Ctx(esam, runtime, planner=planner)
    disjuncts = norm.children if isinstance(norm, Or) else [norm]
    sources = []
    for d in disjuncts:
        s = _compile_disjunct(d, ctx)
        if s is not None:
            sources.append(s)
    sources = _fuse_scan_disjuncts(sources, ctx)
    if planner is not None and any(s.strategy == "residual"
                                   for s in sources):
        # a measured yield collapse at this (predicate, delta version)
        # starts re-compiled residual loops at the full prefilter scan —
        # same verified ranking, without replaying the doubling ramp
        if planner.residual_full(norm.key(), int(runtime.delta.version)):
            for s in sources:
                if s.strategy == "residual":
                    s.residual_full = True
    if any(s.verify is not None for s in sources):
        seqs = getattr(runtime, "sequences", None)
        if not seqs or len(seqs) != ctx.n:
            raise ValueError(
                "predicate needs residual verification but the runtime has "
                "no stored sequences (rebuild or re-save the index with "
                "sequences attached)")
    est = min(ctx.n, sum(s.est for s in sources))
    return CompiledPredicate(key=norm.key(), pred=norm, sources=sources,
                             est=est)


def _fuse_scan_disjuncts(sources: List[CompiledSource], ctx: _Ctx
                         ) -> List[CompiledSource]:
    """OR of brute-forced disjuncts: union the covers via one membership
    bitmap so overlapping ids are scanned once, not once per disjunct.
    Raw-only chains join the union (their covers often nest — V_'ab' ⊆
    V_'a'); graph-backed chains keep their beam searches.

    On the jax backend raw-only chains are NOT fused: their CSR segment
    lists are descriptor ranges the device executor resolves against the
    resident ``base_ids`` with zero candidate-id upload (DESIGN.md §3);
    materializing the union would trade a possibly-nested re-scan on
    device for a host bitmap + per-batch id upload.  Each disjunct keeps
    its own segmented-kernel owner and the executor's merge dedups
    overlapping ids, so exactness is unchanged (each owner's top-k is
    exact over its own cover)."""
    keep_descriptors = ctx.rt.backend == "torch"

    def fusable(s: CompiledSource) -> bool:
        if s.strategy == "scan":
            return True
        return (s.strategy == "chain" and not s.graph_states
                and not keep_descriptors)
    scans = [s for s in sources if fusable(s)]
    if len(scans) < 2:
        return sources
    rest = [s for s in sources if not fusable(s)]
    m = np.zeros(ctx.n, dtype=bool)
    for s in scans:
        if s.ids is not None:
            m[s.ids] = True
        else:
            for lo, hi in s.segments:
                m[ctx.rt.base_ids[lo:hi]] = True
        if s.delta_ids is not None:
            m[s.delta_ids] = True
    ids = np.nonzero(m)[0].astype(np.int64)
    if len(ids) == 0:
        return rest
    return rest + [CompiledSource(strategy="scan", ids=ids, est=len(ids))]
