"""NFA pattern/sequence engine over dense per-key match-slot tensors.

Counterpart of ``siddhi_tpu/ops/nfa.py``. The reference's pending-state
event lists (``StreamPreStateProcessor.java:364-403``, a scan of a linked
list of partial matches per incoming event) become fixed-capacity slot
tensors, a dict of torch tensors on the app's device:

    active  [K, S] bool      — slot holds a partial match
    stepi   [K, S] int32     — pattern position the slot is resting at
    bits    [K, S] int32     — matched-sides mask for logical and/or steps
    vbits   [K, S] int32     — violated absent sides of a logical step
    sts     [K, S] int64     — first-event timestamp (drives `within`)
    adl/adl2 [K, S] int64    — absent-side deadlines (`not X for t`)
    wts<g>  [K, S] int64     — per-`within`-scope start timestamps
    capdone [K, S] int32     — bitmask of capture-ids already filled
                               (top bits flag started within-scopes)
    caps    {c<cid>__<col>: [K, S]} — captured attribute values per ref
            (count refs also keep per-index slots c<cid>i<i>__<col> and an
             occurrence counter c<cid>__#n)

K = partition keys (1 when unpartitioned), S = slot capacity. The plan half
(``build_nfa_plan`` and the capture-column naming) is host Python, kept as
the reference has it. One step processes a whole batch on one stream:

- ``_apply_stream_generic`` (the reference's K5) runs one *round* per
  same-key occurrence: rows of one round have distinct keys, so a round's
  slot updates are one gather/scatter over every key at once. The
  reference's ``lax.while_loop`` becomes a Python loop whose rounds the
  host lays out from its own copy of the partition keys (``round_rows``):
  a round works on its own rows only ([n_r, S] instead of [B, S]) and the
  loop costs no device read.
- ``_apply_stream_fast`` (the reference's K4) handles the two-step chain
  family (``e1=A -> e2=B`` and ``e1=A, e2=B``, with or without ``every``
  and a whole-pattern ``within``) in closed form. The runtime decides on
  the host when a batch is hard for it (``expire_to`` first, then K5).
- ``apply_timer`` sweeps the absent deadlines of every key at a TIMER
  tick.

Every step updates the state dict's tensors (or replaces them) and returns
it with the match emission: ``[B·(S+1)]`` rows, by input row then slot,
with the spare column S for matches that complete on a fresh event.

Semantics are the reference's (see ``siddhi_tpu/ops/nfa.py`` for the
reference file:line of each rule): PATTERN keeps pending matches across
non-matching events, SEQUENCE kills what an event fails to extend,
``every`` re-arms, ``within`` expires lazily against the triggering
event's time, absent states wait with deadlines, counts accumulate into
one partial match, logical and/or match their sides in any order.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from siddhi_tpu_torch.ops.expressions import (
    PK_KEY,
    TS_KEY,
    TYPE_KEY,
    VALID_KEY,
    ColumnRef,
    CompileError,
    Resolver,
)
from siddhi_tpu_torch.ops.keyed_windows import _per_key_layout
from siddhi_tpu_torch.ops.scatter import put_where_
from siddhi_tpu_torch.ops.types import TORCH_OF_NUMPY
from siddhi_tpu_torch.query_api.definitions import AttrType, StreamDefinition
from siddhi_tpu_torch.query_api.execution import (
    AbsentStreamStateElement,
    CountStateElement,
    EveryStateElement,
    LogicalStateElement,
    NextStateElement,
    StateInputStream,
    StateInputStreamType,
    StreamStateElement,
)
from siddhi_tpu_torch.query_api.expressions import Expression, Variable

CURRENT, EXPIRED, TIMER, RESET = 0, 1, 2, 3
ANY_MAX = 2 ** 30
FAR_FUTURE = np.int64(2 ** 62)
# T0 sentinel for capture-less armed heads: within counts from the first
# capture; 2**60 keeps T0 + within far below int64 overflow
_T0_FAR = np.int64(2 ** 60)
_FAR = int(FAR_FUTURE)

# --------------------------------------------------------------------- plan


@dataclass
class CaptureSpec:
    """One capturable stream reference (``e1=...``)."""

    cid: int
    ref_id: Optional[str]
    stream_id: str
    definition: StreamDefinition
    is_count: bool = False
    n_idx: int = 0               # indexed slots kept (max referenced idx + 1)
    last_offsets: set = field(default_factory=set)  # e[last - k] offsets used
    last_ring: int = 0           # shift-register depth for e[last - k] on
    #                              OPEN-ENDED counts (`+`/`<n:>`): the last
    #                              k+1 events ride dense ring columns instead
    #                              of bounded indexed slots


@dataclass
class SideSpec:
    """One stream-consuming side of a step (logical steps have two)."""

    stream_id: str
    definition: StreamDefinition
    capture: Optional[CaptureSpec]       # None for absent sides
    filter_exprs: list = field(default_factory=list)  # query-api Expressions
    cond: Optional[Callable] = None                   # compiled later
    bit: int = 1
    absent: bool = False
    wait_ms: Optional[int] = None        # absent `for <t>` deadline


@dataclass
class StepSpec:
    index: int
    kind: str                    # 'stream' | 'count' | 'absent' | 'and' | 'or'
    sides: List[SideSpec]
    min_count: int = 1
    max_count: int = 1
    sticky: bool = False         # mid-chain `every` re-arm point
    wait_ms: Optional[int] = None  # absent steps

    @property
    def need_bits(self) -> int:
        """Sides that must affirmatively fire for an 'and' step to
        complete: present sides plus absent sides with a deadline (absent
        sides *without* a wait are satisfied-unless-violated)."""
        b = 0
        for s in self.sides:
            if not s.absent or s.wait_ms is not None:
                b |= s.bit
        return b

    @property
    def skippable(self) -> bool:
        return self.kind == "count" and self.min_count == 0

    @property
    def waitish(self) -> bool:
        """The step holds resting slots with deadlines."""
        if self.kind == "absent":
            return True
        return self.kind in ("and", "or") and any(
            s.absent and s.wait_ms is not None for s in self.sides)


@dataclass
class NFAPlan:
    steps: List[StepSpec]
    captures: List[CaptureSpec]
    every: bool
    sequence: bool
    within: Optional[int]        # milliseconds, whole-pattern
    slots: int
    stream_ids: List[str]        # unique consumed stream ids, stable order
    scopes: List[Tuple[int, int, int]] = field(default_factory=list)
    # `every (...)` group spans: start step -> end step. A new group
    # iteration arms only when no live slot is still INSIDE the span —
    # the reference starts the next iteration on group COMPLETION
    # (StreamPostStateProcessor.process -> addEveryState), so grouped
    # chains are non-overlapping (EveryPatternTestCase:282) while
    # single-state every (span start==end) stays per-event
    every_groups: Dict[int, int] = field(default_factory=dict)
    # non-every pattern whose head is a COUNT state: the start state
    # re-arms when no chain is live (after a completed match or a
    # within-expiry) — CountPreStateProcessor keeps collecting on the
    # shared state event (CountPatternTestCase.testQuery20 expects two
    # matches); plain stream heads match once, as our corpus pins
    rearm_on_empty: bool = False

    @property
    def last_step(self) -> int:
        return len(self.steps) - 1

    @property
    def eager_tail_start(self) -> int:
        """First index t such that steps t..last are ALL min-0 counts: a
        chain resting at/after t is already complete and emits eagerly
        (reference processMinCountReached fires at min 0 on addState —
        SequenceTestCase.testQuery3 `every e1, e2*` emits per e1)."""
        t = len(self.steps)
        for st in reversed(self.steps):
            if st.kind == "count" and st.min_count == 0:
                t = st.index
            else:
                break
        return t

    @property
    def has_absent(self) -> bool:
        return any(
            st.kind == "absent" or any(s.absent for s in st.sides)
            for st in self.steps
        )

    def scope_bit(self, g: int) -> int:
        """capdone bit flagging scope g as started (top bits, below sign)."""
        return 1 << (30 - g)

    def arm_step(self) -> Optional[int]:
        """Head step that needs an *armed* waiting slot at key creation:
        the first non-skippable step when it is absent-ish (a pure-present
        head arms lazily through fresh starts instead)."""
        for st in self.steps:
            if st.skippable:
                continue
            if st.kind == "absent" or (
                st.kind in ("and", "or") and any(s.absent for s in st.sides)
            ):
                return st.index
            return None
        return None


def _flatten(el, elements: List, scopes: List, sticky_at: set, depth: int,
             groups: Dict[int, int]):
    """Linearize the state-element tree; record `within` scopes as element
    index ranges, mid-chain `every` re-arm points, and every-group spans."""
    if isinstance(el, NextStateElement):
        a = len(elements)
        _flatten(el.state, elements, scopes, sticky_at, depth + 1, groups)
        _flatten(el.next, elements, scopes, sticky_at, depth + 1, groups)
        if el.within is not None:
            scopes.append((a, len(elements) - 1, el.within))
        return
    if isinstance(el, EveryStateElement):
        a = len(elements)
        _flatten(el.state, elements, scopes, sticky_at, depth + 1, groups)
        groups[a] = len(elements) - 1
        if a > 0:
            sticky_at.add(a)          # mid-chain every: re-arm point
        if el.within is not None:
            scopes.append((a, len(elements) - 1, el.within))
        return
    a = len(elements)
    elements.append(el)
    if getattr(el, "within", None) is not None:
        scopes.append((a, a, el.within))


def build_nfa_plan(
    state_stream: StateInputStream,
    definitions: Dict[str, StreamDefinition],
    slots: int,
) -> NFAPlan:
    """Linearize the state-element tree into step specs (the role of
    ``StateInputStreamParser.java:76-210`` building the InnerStateRuntime
    tree — flat here because the chain is executed as step indices)."""
    within = state_stream.within
    root = state_stream.state_element

    elements: List = []
    scopes: List[Tuple[int, int, int]] = []
    sticky_at: set = set()
    every_groups: Dict[int, int] = {}
    _flatten(root, elements, scopes, sticky_at, 0, every_groups)

    # `every` wrapping the head (whole pattern or first element) is the
    # global re-arm flag; scopes recorded at element 0 spanning everything
    # with the root's within fold into the whole-pattern within
    every = False
    if isinstance(root, EveryStateElement):
        every = True
        if root.within is not None:
            w = root.within
            within = w if within is None else min(within, w)
            scopes = [s for s in scopes
                      if not (s[0] == 0 and s[1] == len(elements) - 1 and s[2] == w)]
    elif elements:
        # `every A -> B` parses as Next(Every(A), B): an every wrapping the
        # FIRST element is the global re-arm flag (_flatten only marks
        # every at positions > 0 as sticky)
        first = root
        while isinstance(first, NextStateElement):
            first = first.state
        if isinstance(first, EveryStateElement):
            every = True

    sequence = state_stream.state_type == StateInputStreamType.SEQUENCE

    captures: List[CaptureSpec] = []
    steps: List[StepSpec] = []

    from siddhi_tpu_torch.query_api.execution import Filter

    def make_side(stream_el: StreamStateElement, is_count: bool,
                  absent: bool) -> SideSpec:
        s = stream_el.stream
        sid = s.stream_id
        if sid not in definitions:
            raise CompileError(f"pattern stream '{sid}' is not defined")
        cap = None
        if not absent:
            cap = CaptureSpec(
                cid=len(captures),
                ref_id=s.stream_reference_id,
                stream_id=sid,
                definition=definitions[sid],
                is_count=is_count,
            )
            captures.append(cap)
        elif s.stream_reference_id is not None:
            raise CompileError(
                "absent (`not`) pattern streams cannot be captured with e=")
        filters = []
        for h in s.handlers:
            if isinstance(h, Filter):
                filters.append(h.expression)
            else:
                raise CompileError(
                    "only [filter] handlers are allowed on pattern streams"
                )
        wait = getattr(stream_el, "waiting_time", None) if absent else None
        return SideSpec(
            stream_id=sid,
            definition=definitions[sid],
            capture=cap,
            filter_exprs=filters,
            absent=absent,
            wait_ms=wait,
        )

    for ei, el in enumerate(elements):
        idx = len(steps)
        sticky = ei in sticky_at
        if isinstance(el, AbsentStreamStateElement):
            if el.waiting_time is None:
                raise CompileError(
                    "a chained absent pattern needs `for <time>`")
            side = make_side(el, is_count=False, absent=True)
            steps.append(StepSpec(index=idx, kind="absent", sides=[side],
                                  sticky=sticky, wait_ms=el.waiting_time))
        elif isinstance(el, CountStateElement):
            side = make_side(el.state, is_count=True, absent=False)
            mn = el.min_count if el.min_count != CountStateElement.ANY else 0
            mx = el.max_count if el.max_count != CountStateElement.ANY else ANY_MAX
            steps.append(StepSpec(index=idx, kind="count", sides=[side],
                                  min_count=mn, max_count=mx, sticky=sticky))
        elif isinstance(el, LogicalStateElement):
            sides = []
            for sub in (el.stream1, el.stream2):
                absent = isinstance(sub, AbsentStreamStateElement)
                sides.append(make_side(sub, is_count=False, absent=absent))
            sides[0].bit, sides[1].bit = 1, 2
            if el.type == "or":
                for s in sides:
                    if s.absent and s.wait_ms is None:
                        raise CompileError(
                            "an absent `or` side needs `for <time>`")
            if all(s.absent for s in sides) and el.type == "and":
                for s in sides:
                    if s.wait_ms is None:
                        raise CompileError(
                            "an all-absent `and` needs `for <time>` on both sides")
            steps.append(StepSpec(index=idx, kind=el.type, sides=sides,
                                  sticky=sticky))
        elif isinstance(el, StreamStateElement):
            side = make_side(el, is_count=False, absent=False)
            steps.append(StepSpec(index=idx, kind="stream", sides=[side],
                                  sticky=sticky))
        else:
            raise CompileError(f"unsupported state element {type(el).__name__}")

    stream_ids: List[str] = []
    for st in steps:
        for side in st.sides:
            if side.stream_id not in stream_ids:
                stream_ids.append(side.stream_id)

    for st in steps:
        # sticky counts re-arm by forking on advance; the forked child's
        # entry is only implemented for plain stream successors (and
        # emission when the count is the last step)
        if (st.kind == "count" and st.sticky and st.index < len(steps) - 1
                and steps[st.index + 1].kind != "stream"):
            raise CompileError(
                "`every` on a count state followed by a "
                f"{steps[st.index + 1].kind} state is not supported")

    # `every` wrapping an ABSENT head (plain or all-absent logical) can't
    # restart through fresh starts (absent heads live as armed waiting
    # slots) — make the armed slot sticky so each elapsed quiet window
    # forks a pending successor (EveryAbsentSequenceTestCase /
    # EveryAbsentPatternTestCase re-arming). Heads with a present side
    # carry captures and keep the non-sticky path.
    if (every and len(steps) > 1 and steps[0].waitish
            and all(s.absent for s in steps[0].sides)):
        steps[0].sticky = True

    if len(scopes) > 8:
        raise CompileError("at most 8 nested `within` scopes are supported")
    if len(captures) > 30 - len(scopes):
        raise CompileError("too many pattern captures for one query")

    return NFAPlan(
        steps=steps,
        captures=captures,
        every=every,
        sequence=sequence,
        within=within,
        slots=slots,
        stream_ids=stream_ids,
        scopes=scopes,
        every_groups=every_groups,
        rearm_on_empty=(not every and not sequence and bool(steps)
                        and steps[0].kind == "count"),
    )


def _walk_expressions(expr, visit):
    if expr is None:
        return
    visit(expr)
    for attr_name in ("left", "right", "expression"):
        child = getattr(expr, attr_name, None)
        if isinstance(child, Expression):
            _walk_expressions(child, visit)
    params = getattr(expr, "parameters", None)
    if params:
        for p in params:
            _walk_expressions(p, visit)


def assign_indexed_captures(plan: NFAPlan, exprs: List) -> None:
    """Scan expressions for ``e1[i].attr`` references and size each
    capture's indexed storage (reference keeps the full StreamEvent chain;
    here only statically-referenced indices are materialized)."""

    def visit(e):
        if not isinstance(e, Variable) or e.stream_index is None:
            return
        idx = e.stream_index
        for cap in plan.captures:
            if e.stream_id not in (cap.ref_id, cap.stream_id):
                continue
            if idx == "last":
                return   # the unindexed capture IS the last event
            if isinstance(idx, tuple) and idx[0] == "last":
                k = -idx[1]
                if not cap.is_count:
                    raise CompileError(
                        "e[last - k] needs a count capture (e<min:max>)")
                mx = _count_max_of(plan, cap)
                if mx >= ANY_MAX:
                    # open-ended count (`+`, `<n:>`): the last k+1 events
                    # ride a dense shift register (ring columns) — the
                    # bounded-slot scheme can't size the chain
                    cap.last_ring = max(cap.last_ring, k)
                else:
                    # bounded: the k-th from the end is a runtime position;
                    # keep every indexed slot up to the bounded max
                    cap.n_idx = max(cap.n_idx, mx)
                cap.last_offsets.add(k)
                return
            if not isinstance(idx, int):
                raise CompileError(
                    f"event index '{idx}' is not supported (e[<int>], "
                    f"e[last], e[last - k])")
            if cap.is_count:  # non-count refs hold a single event
                cap.n_idx = max(cap.n_idx, idx + 1)
            return
        raise CompileError(f"unknown pattern reference '{e.stream_id}'")

    for expr in exprs:
        _walk_expressions(expr, visit)


# ----------------------------------------------------------------- columns


def cap_col(cid: int, attr: str) -> str:
    return f"c{cid}__{attr}"


def cap_idx_col(cid: int, i: int, attr: str) -> str:
    return f"c{cid}i{i}__{attr}"


def cap_cnt_col(cid: int) -> str:
    return f"c{cid}__#n"


def cap_lastk_col(cid: int, j: int, attr: str) -> str:
    """Ring column: the j-th-from-last captured event of an OPEN count —
    'R' namespace, distinct from cap_last_col's bounded-slot 'L' derived
    columns so the two storage schemes can never alias."""
    return f"c{cid}R{j}__{attr}"


PRESENT = "@present"   # synthetic attr: StateEvent presence (bare `e2 is
#                        null` / `e2[last-k] is null` checks read its mask)


def cap_last_col(cid: int, k: int, attr: str) -> str:
    return f"c{cid}L{k}__{attr}"


def _count_max_of(plan: NFAPlan, cap: CaptureSpec) -> int:
    for st in plan.steps:
        for side in st.sides:
            if side.capture is cap:
                return st.max_count
    return ANY_MAX


def scope_col(g: int) -> str:
    return f"wts{g}"


def _resolve_cap(plan: NFAPlan, var: Variable) -> Optional[Tuple[CaptureSpec, object]]:
    from siddhi_tpu_torch.query_api.definitions import Attribute

    sid = var.stream_id
    if var.attribute_name is None:
        # bare indexed ref (`e2[last-1] is null`): StateEvent presence —
        # a synthetic BOOL column whose null mask is exactly absence
        for cap in plan.captures:
            if sid in (cap.ref_id, cap.stream_id):
                return cap, Attribute(PRESENT, AttrType.BOOL)
        return None
    for cap in plan.captures:
        if sid is not None and sid not in (cap.ref_id, cap.stream_id):
            continue
        try:
            attr = cap.definition.attribute(var.attribute_name)
        except Exception:
            continue
        return cap, attr
    if sid is None:
        # bare capture name (`e2 is null` — StateEvent presence check)
        for cap in plan.captures:
            if var.attribute_name == cap.ref_id:
                return cap, Attribute(PRESENT, AttrType.BOOL)
    return None


def _cap_ref(plan: NFAPlan, var: Variable) -> Optional[ColumnRef]:
    got = _resolve_cap(plan, var)
    if got is None:
        return None
    cap, attr = got
    idx = var.stream_index
    if idx is not None:
        if idx == "last":
            return ColumnRef(cap_col(cap.cid, attr.name), attr.type)
        if isinstance(idx, tuple) and idx[0] == "last":
            k = -idx[1]
            if cap.last_ring >= k > 0:
                # open-count shift register: live in state, so usable in
                # mid-chain side filters too
                return ColumnRef(cap_lastk_col(cap.cid, k, attr.name),
                                 attr.type)
            # bounded count: derived column materialized by the flatten stage
            return ColumnRef(cap_last_col(cap.cid, k, attr.name), attr.type)
        if not isinstance(idx, int):
            raise CompileError(
                "only e[<int>], e[last], e[last - k] indexing is supported")
        if idx >= max(cap.n_idx, 1) and cap.is_count:
            raise CompileError(
                f"index {idx} out of the capture's sized range"
            )
        if not cap.is_count and idx != 0:
            raise CompileError("only count states capture multiple events")
        if cap.is_count:
            return ColumnRef(cap_idx_col(cap.cid, idx, attr.name), attr.type)
    return ColumnRef(cap_col(cap.cid, attr.name), attr.type)


class NFASideResolver(Resolver):
    """Resolve variables inside a step-side filter: the side's own stream
    attributes read the current event; references to other captures read
    capture columns (last event by default, e[i] for indexed)."""

    def __init__(self, side: SideSpec, plan: NFAPlan, dictionary):
        self.side = side
        self.plan = plan
        self.dictionary = dictionary

    def resolve(self, var: Variable) -> ColumnRef:
        sid = var.stream_id
        side = self.side
        ref_id = side.capture.ref_id if side.capture is not None else None
        own = sid is None or sid == ref_id or (ref_id is None and sid == side.stream_id)
        if own and var.stream_index is None:
            try:
                attr = side.definition.attribute(var.attribute_name)
                return ColumnRef(attr.name, attr.type)
            except Exception:
                if sid is not None and _cap_ref(self.plan, var) is None:
                    raise
        ref = _cap_ref(self.plan, var)
        if ref is not None:
            return ref
        raise CompileError(
            f"cannot resolve '{(sid + '.') if sid else ''}{var.attribute_name}' "
            f"in pattern filter"
        )

    def encode_string(self, s: str) -> int:
        return self.dictionary.encode(s)


class NFAOutputResolver(Resolver):
    """Resolve selector variables of a pattern query against capture
    columns (``e1.price``, ``e1[0].price``, or bare stream names)."""

    def __init__(self, plan: NFAPlan, dictionary):
        self.plan = plan
        self.dictionary = dictionary
        self.synthetic: Dict[str, AttrType] = {}

    def resolve(self, var: Variable) -> ColumnRef:
        if var.attribute_name in self.synthetic and var.stream_id is None:
            return ColumnRef(var.attribute_name, self.synthetic[var.attribute_name])
        ref = _cap_ref(self.plan, var)
        if ref is not None:
            return ref
        raise CompileError(
            f"cannot resolve '{(var.stream_id + '.') if var.stream_id else ''}"
            f"{var.attribute_name}' in pattern selector"
        )

    def encode_string(self, s: str) -> int:
        return self.dictionary.encode(s)


# ------------------------------------------------------------ device stage


def _cap_state_cols(plan: NFAPlan) -> Dict[str, np.dtype]:
    """State columns for captured values (value + null-mask per attribute,
    per capture; indexed slots and an occurrence counter for counts)."""
    from siddhi_tpu_torch.ops.types import dtype_of

    cols: Dict[str, np.dtype] = {}
    for cap in plan.captures:
        for a in cap.definition.attributes:
            cols[cap_col(cap.cid, a.name)] = dtype_of(a.type)
            cols[cap_col(cap.cid, a.name) + "?"] = np.bool_
            for i in range(cap.n_idx):
                cols[cap_idx_col(cap.cid, i, a.name)] = dtype_of(a.type)
                cols[cap_idx_col(cap.cid, i, a.name) + "?"] = np.bool_
            for j in range(1, cap.last_ring + 1):
                cols[cap_lastk_col(cap.cid, j, a.name)] = dtype_of(a.type)
                cols[cap_lastk_col(cap.cid, j, a.name) + "?"] = np.bool_
        cols[cap_col(cap.cid, TS_KEY)] = np.int64
        if cap.is_count:
            cols[cap_cnt_col(cap.cid)] = np.int32
    return cols




def _tdt(np_dtype) -> torch.dtype:
    return TORCH_OF_NUMPY[np.dtype(np_dtype)]


def _scalar(v, dtype: torch.dtype, dev) -> torch.Tensor:
    return torch.full((), v, dtype=dtype, device=dev)


def _as_mask(v, shape, dev) -> torch.Tensor:
    """A compiled condition's value (a tensor, or a numpy/Python bool for
    a constant condition) as a bool tensor of ``shape``."""
    if not isinstance(v, torch.Tensor):
        v = torch.as_tensor(np.asarray(v), device=dev)
    return v.to(torch.bool).expand(shape)


def _key_flags(mask, pk, K: int) -> torch.Tensor:
    """[K] bool: some row in ``mask`` has this key (the reference's
    ``.at[where(mask, pk, K)].set(True, mode="drop")``; the spare row K
    takes the masked-out rows)."""
    flags = torch.zeros(K + 1, dtype=torch.bool, device=pk.device)
    flags.index_fill_(0, torch.where(mask, pk, torch.full_like(pk, K)), True)
    return flags[:K]


def round_rows(pk: np.ndarray, valid: np.ndarray):
    """Host layout of the generic engine's rounds: round r holds the valid
    rows that are the r-th of their key in this batch. Returns (rows, bounds):
    the valid row indices ordered by (round, row) and each round's [lo, hi)
    range in that order. Rows of one round have distinct keys."""
    idx = np.nonzero(np.asarray(valid, bool))[0].astype(np.int64)
    if idx.size == 0:
        return idx, []
    p = np.asarray(pk)[idx]
    order = np.argsort(p, kind="stable")
    ps = p[order]
    pos = np.arange(ps.size)
    new = np.ones(ps.size, bool)
    new[1:] = ps[1:] != ps[:-1]
    occ = np.empty(ps.size, np.int64)
    occ[order] = pos - np.maximum.accumulate(np.where(new, pos, 0))
    by = np.argsort(occ, kind="stable")
    ends = np.cumsum(np.bincount(occ))
    starts = np.concatenate([[0], ends[:-1]])
    return idx[by], [(int(a), int(b)) for a, b in zip(starts, ends)]


class NFAStage:
    """Device NFA: per-input-stream step functions over shared slot state.

    ``fast_steps``, ``generic_steps``, ``generic_rounds`` and
    ``timer_steps`` count the K4 steps, the K5 steps and their rounds, and
    the TIMER sweeps this stage ran (host counters)."""

    def __init__(self, plan: NFAPlan):
        self.plan = plan
        self.cap_cols = _cap_state_cols(plan)
        self.scope_cols = [scope_col(g) for g in range(len(plan.scopes))]
        # loop-free kernel for simple two-step chains (see _fast_side);
        # differential tests flip this off to pin fast == generic
        self.fast_enabled = True
        self.fast_steps = 0
        self.generic_steps = 0
        self.generic_rounds = 0
        self.timer_steps = 0

    def init_state(self, num_keys: int, device) -> dict:
        K, S = num_keys, self.plan.slots
        dev = torch.device(device)

        def z(dt):
            return torch.zeros((K, S), dtype=dt, device=dev)

        state = {
            "active": z(torch.bool),
            "stepi": z(torch.int32),
            "bits": z(torch.int32),
            "vbits": z(torch.int32),
            "sts": z(torch.int64),
            "adl": z(torch.int64),
            "adl2": z(torch.int64),
            "capdone": z(torch.int32),
            "consumed": torch.zeros(K, dtype=torch.bool, device=dev),
            "armed": torch.zeros(K, dtype=torch.bool, device=dev),
            "nfa_overflow": torch.zeros((), dtype=torch.int32, device=dev),
        }
        for g in self.scope_cols:
            state[g] = z(torch.int64)
        for name, dt in self.cap_cols.items():
            # '?' mask columns start TRUE: an uncaptured reference (e.g.
            # e1[0].price before anything collected) is NULL, and null
            # comparisons are false (reference StateEvent returns null
            # for absent events; CompareConditionExecutor null guards)
            state[name] = (torch.ones((K, S), dtype=_tdt(dt), device=dev)
                           if name.endswith("?") else z(_tdt(dt)))
        return state

    # ............................................ static eligibility chains

    def _advance_sources(self, j: int) -> List[int]:
        """Resting positions p < j a slot can advance from when step j's
        event arrives: walk back across count steps; positions before a
        count with min > 0 are unreachable."""
        out = []
        p = j - 1
        while p >= 0:
            st = self.plan.steps[p]
            if st.kind != "count":
                break
            out.append(p)
            if st.min_count != 0:
                break
            p -= 1
        return out

    def _fresh_ok(self, j: int) -> bool:
        """A fresh (unstarted) match can begin at step j iff every earlier
        step is a skippable min-0 count and step j itself has no absent
        machinery (absent heads run through *armed* waiting slots)."""
        st = self.plan.steps[j]
        if st.kind == "absent" or any(s.absent for s in st.sides):
            return False
        return all(self.plan.steps[p].skippable for p in range(j))

    # ........................................................ slot entering

    def _enter(self, V: dict, mask2d, j: int, ts2d):
        """Slots (masked) come to rest at step j: set position, clear the
        logical bookkeeping, arm absent deadlines. ``ts2d`` broadcasts
        against [B, S]."""
        plan = self.plan

        def w(dst, val):
            return torch.where(mask2d, val, dst)

        V["ST"] = w(V["ST"], j)
        V["BT"] = w(V["BT"], 0)
        V["VB"] = w(V["VB"], 0)
        if j <= plan.last_step:
            st = plan.steps[j]
            if st.kind == "absent":
                V["ADL"] = w(V["ADL"], ts2d + st.wait_ms)
            elif st.kind in ("and", "or"):
                for side in st.sides:
                    if side.absent and side.wait_ms is not None:
                        key = "ADL" if side.bit == 1 else "AD2"
                        V[key] = w(V[key], ts2d + side.wait_ms)
        return V

    def _start_capture_scopes(self, V: dict, mask2d, j: int, ts2d):
        """Scopes whose start step j captured its first event now (a scope
        starting at a capture-LESS waitish step anchors at its first
        capturing successor: the reference measures `within` across
        captured events only)."""
        plan = self.plan
        for g, (a, b, t) in enumerate(plan.scopes):
            starts_here = a == j
            enters_here = (a < j <= b and plan.steps[a].waitish
                           and all(s.capture is None
                                   for s in plan.steps[a].sides))
            if starts_here or enters_here:
                started = (V["CD"] & plan.scope_bit(g)) != 0
                m = mask2d & ~started
                V["SC"][g] = torch.where(m, ts2d, V["SC"][g])
                V["CD"] = torch.where(m, V["CD"] | plan.scope_bit(g), V["CD"])
        return V

    # .......................................................... expiry pass

    def _expire(self, V: dict, ts2d):
        """Kill partial matches past the whole-pattern `within` or past a
        started scope's bound (reference expireEvents)."""
        plan = self.plan
        A = V["A"]
        if plan.within is not None:
            A = A & ~(ts2d > V["T0"] + plan.within)
        for g, (a, b, t) in enumerate(plan.scopes):
            started = (V["CD"] & plan.scope_bit(g)) != 0
            if a == 0 and b == plan.last_step:
                # scope == whole pattern: same as plan.within on T0
                A = A & ~(started & (ts2d > V["SC"][g] + t))
                continue
            in_scope = (V["ST"] > a) & (V["ST"] <= b)
            if plan.steps[a].waitish:
                in_scope = in_scope | (V["ST"] == a)
            A = A & ~(started & in_scope & (ts2d > V["SC"][g] + t))
        V["A"] = A
        return V

    # ...................................................... deadline engine

    def _cascade(self, V: dict, ts2d, emit, ets, fork_reqs: List):
        """Advance waiting slots whose absent deadlines have passed; one
        ascending pass chains consecutive waits. ``fork_reqs`` collects
        (mask2d, target_step, arm_ts2d) for sticky re-arms needing a forked
        child (allocated by the caller)."""
        plan = self.plan
        L = plan.last_step
        for st in plan.steps:
            j = st.index
            if st.kind == "absent":
                at = V["A"] & (V["ST"] == j)
                due = at & (ts2d >= V["ADL"])
                if st.sticky:
                    if j == L:
                        emit = emit | due
                        ets = torch.where(due, V["ADL"], ets)
                    elif j == 0:
                        # head every-absent: pending successors carry no
                        # captures, so keep at most ONE per key
                        pending = (V["A"] & (V["ST"] == j + 1)).any(
                            dim=1, keepdim=True)
                        fork_reqs.append((due & ~pending, j + 1, V["ADL"]))
                    else:
                        fork_reqs.append((due, j + 1, V["ADL"]))
                    V["ADL"] = torch.where(due, V["ADL"] + st.wait_ms, V["ADL"])
                else:
                    if j == L:
                        emit = emit | due
                        ets = torch.where(due, V["ADL"], ets)
                        V["A"] = V["A"] & ~due
                    else:
                        V = self._enter(V, due, j + 1, V["ADL"])
            elif st.kind in ("and", "or"):
                # completion timestamp: 'and' completes when the LAST due
                # side fires (max over due-now deadlines); 'or' when the
                # FIRST does (min) — only deadlines firing now count
                is_and = st.kind == "and"
                comp_ts = None
                init = -_FAR if is_and else _FAR
                fired = torch.zeros_like(V["A"])
                for side in st.sides:
                    if not (side.absent and side.wait_ms is not None):
                        continue
                    adlx = V["ADL"] if side.bit == 1 else V["AD2"]
                    due_s = (
                        V["A"] & (V["ST"] == j) & (ts2d >= adlx)
                        & ((V["BT"] & side.bit) == 0)
                        & ((V["VB"] & side.bit) == 0)
                    )
                    V["BT"] = torch.where(due_s, V["BT"] | side.bit, V["BT"])
                    fired = fired | due_s
                    cand = torch.where(due_s, adlx, init)
                    if comp_ts is None:
                        comp_ts = cand
                    else:
                        comp_ts = (torch.maximum if is_and else torch.minimum)(
                            comp_ts, cand)
                if comp_ts is None:
                    continue
                comp_ts = torch.where(fired, comp_ts, ts2d)
                if st.kind == "and":
                    nb = st.need_bits
                    comp = fired & ((V["BT"] & nb) == nb)
                else:
                    comp = fired
                if st.sticky:
                    if j == L:
                        emit = emit | comp
                        ets = torch.where(comp, comp_ts, ets)
                    elif j == 0 and all(s.absent for s in st.sides):
                        # head every-absent logical: capture-less pending
                        # successors dedupe per key (see the absent branch)
                        pending = (V["A"] & (V["ST"] == j + 1)).any(
                            dim=1, keepdim=True)
                        fork_reqs.append((comp & ~pending, j + 1, comp_ts))
                    else:
                        fork_reqs.append((comp, j + 1, comp_ts))
                    # re-arm the parent's deadlines for the next interval
                    for side in st.sides:
                        if side.absent and side.wait_ms is not None:
                            key = "ADL" if side.bit == 1 else "AD2"
                            V[key] = torch.where(
                                comp, V[key] + side.wait_ms, V[key])
                    V["BT"] = torch.where(comp, 0, V["BT"])
                    V["VB"] = torch.where(comp, 0, V["VB"])
                else:
                    if j == L:
                        emit = emit | comp
                        ets = torch.where(comp, comp_ts, ets)
                        V["A"] = V["A"] & ~comp
                    else:
                        V = self._enter(V, comp, j + 1, comp_ts)
        return V, emit, ets

    def _next_deadline(self, state) -> Optional[torch.Tensor]:
        """Earliest pending absent deadline across all keys/slots (FAR_FUTURE
        when none; None for a plan without deadlines) — drives scheduler
        wake-up."""
        plan = self.plan
        nd = None
        A, ST = state["active"], state["stepi"]

        def fold(nd, wait, adl):
            v = torch.where(wait, adl, _FAR).amin()
            return v if nd is None else torch.minimum(nd, v)

        for st in plan.steps:
            j = st.index
            if st.kind == "absent":
                nd = fold(nd, A & (ST == j), state["adl"])
            elif st.kind in ("and", "or"):
                for side in st.sides:
                    if side.absent and side.wait_ms is not None:
                        adlx = state["adl"] if side.bit == 1 else state["adl2"]
                        wait = (
                            A & (ST == j)
                            & ((state["bits"] & side.bit) == 0)
                            & ((state["vbits"] & side.bit) == 0)
                        )
                        nd = fold(nd, wait, adlx)
        return nd

    def _notify(self, state) -> torch.Tensor:
        nd = self._next_deadline(state)
        if nd is None:
            return _scalar(-1, torch.int64, state["active"].device)
        return torch.where(nd >= _FAR, -1, nd)

    # ....................................................... fork allocator

    def _alloc_forks(self, V: dict, req2d, overflow):
        """Allocate one free slot per requesting slot and copy the source
        slot's whole per-slot state into it. Returns (V, dst_mask,
        overflow); callers then `_enter`/capture at dst_mask positions."""
        S = self.plan.slots
        A = V["A"]
        n = A.shape[0]
        dev = A.device
        ar = torch.arange(S, device=dev)
        free = ~A
        n_free = free.sum(dim=1)
        fs = torch.argsort(torch.where(free, ar, S + ar), dim=1, stable=True)
        rank = torch.cumsum(req2d.to(torch.int64), dim=1) - 1
        can = req2d & (rank < n_free[:, None])
        overflow = overflow + (req2d & ~can).sum().to(torch.int32)
        dst = torch.where(can, torch.gather(fs, 1, rank.clamp(0, S - 1)), S)
        src_idx = ar.expand(n, S)
        # refused forks all land in the spare column S, sliced away: the
        # other columns are written at most once (one rank per free slot)
        ident = torch.cat([src_idx, torch.zeros((n, 1), dtype=torch.int64,
                                                device=dev)], dim=1)
        src_of_dst = ident.scatter(1, dst, src_idx)[:, :S]
        dst_mask = torch.zeros((n, S + 1), dtype=torch.bool, device=dev).scatter(
            1, dst, True)[:, :S]

        def copy(col):
            return torch.where(dst_mask, torch.gather(col, 1, src_of_dst), col)

        for key in ("ST", "BT", "VB", "T0", "ADL", "AD2", "CD"):
            V[key] = copy(V[key])
        V["CP"] = {nm: copy(c) for nm, c in V["CP"].items()}
        V["SC"] = [copy(c) for c in V["SC"]]
        V["A"] = A | dst_mask
        return V, dst_mask, overflow

    # .................................................. one stream's step

    def apply_stream(self, stream_id: str, state: dict, cols: dict, ctx: dict,
                     rounds=None):
        """Process one batch arriving on ``stream_id``; returns
        (state, out_cols) where out_cols is a flattened [B*(S+1)] match
        emission (capture columns + __ts__/__type__/__valid__/__gk__,
        ``__overflow__`` and ``__notify__``); the fast kernel's head
        batches, which complete no match, emit no rows.

        Two-step chains take the loop-free fast kernel (the dominant
        production shape — BASELINE config #4); everything else the
        generic per-round engine. ``rounds`` is the host's ``round_rows``
        layout of the batch (rows, bounds), which the generic engine
        needs."""
        side_kind = self._fast_side(stream_id) if self.fast_enabled else None
        if side_kind is not None:
            return self._apply_stream_fast(stream_id, state, cols, ctx,
                                           side_kind)
        return self._apply_stream_generic(stream_id, state, cols, ctx, rounds)

    def expire_to(self, state, hwm_per_key):
        """Physically clear every pending past its `within` deadline as
        of its KEY's event-time high-water mark ``hwm_per_key`` ([K] numpy).
        The fast kernels expire LAZILY (masks, no state writes) — exact
        for monotone feeds; before a host-forced fallback to the generic
        engine (out-of-order batch), the runtime applies the clears the
        generic engine would already have made, so the fallback cannot
        resurrect an expired pending."""
        w = self.plan.within
        if w is None:
            return state
        K = state["active"].shape[0]
        hwm = torch.as_tensor(np.asarray(hwm_per_key, np.int64)[:K],
                              device=state["active"].device)
        state["active"] = state["active"] & ~(state["sts"] + w < hwm[:, None])
        return state

    def _fast_side(self, stream_id: str):
        """'head'/'tail' when ``stream_id`` feeds a fast-eligible plan:
        exactly two plain single-side stream steps on DIFFERENT streams,
        simple captures, no counts/absent/logical/sticky/scopes — the
        `e1=A -> e2=B` / `e1=A, e2=B` family (with or without `every` /
        whole-pattern `within`)."""
        plan = self.plan
        if len(plan.steps) != 2 or plan.scopes or plan.rearm_on_empty:
            return None
        if any(a != b or a != 0 for a, b in plan.every_groups.items()):
            return None
        for st in plan.steps:
            if st.kind != "stream" or st.sticky or len(st.sides) != 1:
                return None
            s = st.sides[0]
            if s.absent or s.wait_ms is not None or s.capture is None:
                return None
            c = s.capture
            if c.is_count or c.n_idx or c.last_offsets or c.last_ring:
                return None
        s0, s1 = plan.steps[0].sides[0], plan.steps[1].sides[0]
        if s0.stream_id == s1.stream_id:
            return None
        if stream_id == s0.stream_id:
            return "head"
        if stream_id == s1.stream_id:
            return "tail"
        return None

    def _fast_ev(self, CP, CD, B, fresh: bool, dev):
        """Eval dict for a side condition, mirroring the generic round's
        construction for non-count captures: capture cols [B, S] (or fresh
        NULLs [B, 1]), presence synthetics, current attrs [B, 1]."""
        plan = self.plan
        ev = {}
        if fresh:
            for nm, dt in self.cap_cols.items():
                ev[nm] = (torch.ones((B, 1), dtype=_tdt(dt), device=dev)
                          if nm.endswith("?")
                          else torch.zeros((B, 1), dtype=_tdt(dt), device=dev))
            for cap in plan.captures:
                ev[cap_col(cap.cid, PRESENT)] = torch.ones(
                    (B, 1), dtype=torch.bool, device=dev)
                ev[cap_col(cap.cid, PRESENT) + "?"] = torch.ones(
                    (B, 1), dtype=torch.bool, device=dev)
        else:
            ev.update(CP)
            for cap in plan.captures:
                ev[cap_col(cap.cid, PRESENT)] = torch.ones_like(CD, dtype=torch.bool)
                ev[cap_col(cap.cid, PRESENT) + "?"] = (CD & (1 << cap.cid)) == 0
        return ev

    def _fast_out(self, emit, emit_caps, ts, cols, pk32, B):
        """[B, S] tail emission tensors -> the generic flattened format."""
        dev = emit.device
        spare = torch.zeros((B, 1), dtype=torch.bool, device=dev)
        out_valid = torch.cat([emit, spare], dim=1)
        out_caps = {}
        for nm, dt in list(self.cap_cols.items()) + [("__capdone__", np.int32)]:
            tdt = _tdt(dt)
            zero = torch.zeros((), dtype=tdt, device=dev)
            body = (torch.where(emit, emit_caps[nm], zero) if nm in emit_caps
                    else zero.expand(emit.shape))
            out_caps[nm] = torch.cat(
                [body, torch.zeros((B, 1), dtype=tdt, device=dev)], dim=1)
        out_ts = ts[:, None].expand(B, self.plan.slots + 1)
        return self._flatten_out(out_valid, out_caps, out_ts, cols, pk32, B)

    def _apply_stream_fast(self, stream_id, state, cols, ctx, side_kind):
        """Loop-free two-step chain kernel (the reference's K4).

        Closed forms replacing the per-round loop (each held against the
        generic engine by the differential tests):
        - tail (e2) batches never arm, so consumption is "first matching
          row per slot" — a scatter-min over row indices; SEQUENCE kills
          reduce to "the key's first row decides everything".
        - head (e1) batches never consume, so arming is rank-allocation of
          free slots in index order. The one serial case — a `within`
          expiry boundary crossing between two same-key arming rows, which
          re-orders the free list mid-batch — the runtime's host check
          sends to the generic engine (``NFAQueryRuntime._host_hard_batch``).
        - SEQUENCE head batches: every event kills what it cannot extend,
          so only the LAST row per key can remain pending, always at the
          lowest free slot (index 0 once everything is killed).
        """
        self.fast_steps += 1
        plan = self.plan
        S = plan.slots
        L = plan.last_step
        K = state["consumed"].shape[0]
        B = cols[VALID_KEY].shape[0]
        dev = state["active"].device
        ts = cols[TS_KEY]
        ts2d = ts[:, None]
        valid_cur = cols[VALID_KEY] & (cols[TYPE_KEY] == CURRENT)
        pk32 = (cols[PK_KEY] if PK_KEY in cols
                else torch.zeros(B, dtype=torch.int32, device=dev))
        pk = pk32.to(torch.int64).clamp(0, K - 1)
        w = plan.within
        cap_names = list(self.cap_cols)
        side = (plan.steps[0] if side_kind == "head" else plan.steps[1]).sides[0]
        in_def = side.definition

        def cur_ev(ev):
            for a in in_def.attributes:
                ev[a.name] = cols[a.name][:, None]
                ev[a.name + "?"] = cols[a.name + "?"][:, None]
            ev[TS_KEY] = ts2d
            return ev

        head_cap = plan.steps[0].sides[0].capture
        tail_cap = plan.steps[1].sides[0].capture
        head_pref = f"c{head_cap.cid}__"

        if side_kind == "tail":
            cap = side.capture
            at1 = state["active"][pk] & (state["stepi"][pk] == L)
            # slot state for the TAIL capture is never written by the fast
            # head (and never read): its emission value IS the current row,
            # so ev carries broadcast current values instead of gathers
            CP = {nm: state[nm][pk] for nm in cap_names
                  if nm.startswith(head_pref)}
            for a in tail_cap.definition.attributes:
                CP[cap_col(tail_cap.cid, a.name)] = cols[a.name][:, None].expand(B, S)
                CP[cap_col(tail_cap.cid, a.name) + "?"] = (
                    cols[a.name + "?"][:, None].expand(B, S))
            CP[cap_col(tail_cap.cid, TS_KEY)] = ts2d.expand(B, S)
            CD = state["capdone"][pk]
            ev = cur_ev(self._fast_ev(CP, CD, B, False, dev))
            cond = (_as_mask(side.cond(ev, ctx), (B, S), dev)
                    if side.cond is not None else True)
            match = at1 & cond & valid_cur[:, None]
            if w is not None:
                # lazy per-row expiry — exact for monotone feeds (the host
                # sends out-of-order batches to the generic engine)
                match = match & (ts2d <= state["sts"][pk] + w)
            ridx = torch.arange(B, device=dev)
            if plan.sequence:
                # first VALID row per key consumes its matches and kills
                # the rest; later rows find nothing
                occv = _per_key_layout(pk, valid_cur, K)[2]
                emit = match & (valid_cur & (occv == 0))[:, None]
                touched = _key_flags(valid_cur, pk, K)
                state["active"] = state["active"] & ~touched[:, None]
            else:
                first = torch.full((K, S), B, dtype=torch.int64, device=dev)
                first.scatter_reduce_(
                    0, pk[:, None].expand(B, S),
                    torch.where(match, ridx[:, None], B), "amin",
                    include_self=True)
                emit = match & (ridx[:, None] == first[pk])
                state["active"] = state["active"] & ~(first < B)
            emit_caps = dict(CP)  # c0 = slot state, c1 = current row
            emit_caps["__capdone__"] = CD | (1 << cap.cid)
            out = self._fast_out(emit, emit_caps, ts, cols, pk32, B)
            out["__overflow__"] = _scalar(0, torch.int32, dev)
            out["__notify__"] = self._notify(state)
            return state, out

        # ---- head side
        cap = side.capture
        ev = cur_ev(self._fast_ev(None, None, B, True, dev))
        cond1 = (_as_mask(side.cond(ev, ctx), (B, 1), dev)[:, 0]
                 if side.cond is not None else True)
        arm_c = valid_cur & cond1
        if plan.every:
            arm = arm_c
            occ = _per_key_layout(pk, arm, K)[2]
        else:
            occc = _per_key_layout(pk, arm_c, K)[2]
            arm = arm_c & ~state["consumed"][pk] & (occc == 0)
            occ = torch.zeros(B, dtype=torch.int64, device=dev)
        ov0 = state["nfa_overflow"]
        if plan.sequence:
            # every valid row kills all (non-waitish = all) pendings of
            # its key, then arms at the lowest free slot — only the LAST
            # row per key survives, at slot 0
            _o, _i, occv, cnts, _s = _per_key_layout(pk, valid_cur, K)
            pend = arm & valid_cur & (occv == cnts[pk] - 1)
            flat = pk * S
            state["active"] = state["active"] & ~_key_flags(valid_cur, pk, K)[:, None]
            overflow2 = ov0
        else:
            ar = torch.arange(S, device=dev)
            free = ~state["active"][pk]
            if w is not None:
                free = free | (ts2d > state["sts"][pk] + w)
            n_free = free.sum(dim=1)
            fs = torch.argsort(torch.where(free, ar, S + ar), dim=1, stable=True)
            can = arm & (occ < n_free)
            overflow2 = ov0 + (arm & ~can).sum().to(torch.int32)
            slot = torch.gather(fs, 1, occ.clamp(0, S - 1)[:, None])[:, 0]
            pend = arm & can
            flat = pk * S + slot

        def put2d(name, val):
            # pending rows own distinct (key, slot) cells; put_where_
            # redirects the others to one anchor write of an equal value
            dt = state[name].dtype
            src = (val.to(dt) if isinstance(val, torch.Tensor)
                   else torch.full((B,), val, dtype=dt, device=dev))
            put_where_(state[name].view(-1), 0, flat, src, pend)

        put2d("active", True)
        put2d("stepi", L)
        put2d("bits", 0)
        put2d("vbits", 0)
        put2d("sts", ts)
        put2d("capdone", 1 << cap.cid)
        for nm in cap_names:
            if not nm.startswith(head_pref):
                # tail-capture slot state is never read on the fast path
                # (emissions take the current row); capdone says "not
                # captured"
                continue
            a = nm[len(head_pref):]
            put2d(nm, ts if nm == cap_col(cap.cid, TS_KEY) else cols[a])
        state["consumed"] = state["consumed"] | _key_flags(arm, pk, K)
        state["nfa_overflow"] = overflow2
        # a head batch never completes a match: its emission has no rows
        # (the reference flattens [B·(S+1)] rows, every one invalid)
        out = {VALID_KEY: torch.zeros(0, dtype=torch.bool, device=dev),
               TS_KEY: torch.zeros(0, dtype=torch.int64, device=dev),
               TYPE_KEY: torch.zeros(0, dtype=torch.int8, device=dev),
               "__overflow__": (overflow2 > ov0).to(torch.int32),
               "__notify__": self._notify(state)}
        return state, out

    def _apply_stream_generic(self, stream_id: str, state: dict, cols: dict,
                              ctx: dict, rounds):
        """The generic per-round engine (the reference's K5; see the module
        docstring). Round r runs on the rows that are the r-th of their key
        in the batch, gathered into [n_r, S] views of their keys' slots."""
        self.generic_steps += 1
        plan = self.plan
        S = plan.slots
        L = plan.last_step
        K = state["consumed"].shape[0]
        B = cols[VALID_KEY].shape[0]
        dev = state["active"].device
        ts = cols[TS_KEY]
        pk32 = (cols[PK_KEY] if PK_KEY in cols
                else torch.zeros(B, dtype=torch.int32, device=dev))
        pk = pk32.to(torch.int64).clamp(0, K - 1)
        rows_all, bounds = rounds
        if not isinstance(rows_all, torch.Tensor):
            rows_all = torch.as_tensor(rows_all, device=dev)
        self.generic_rounds += len(bounds)

        # ops consuming this stream, in step order (absent sides included —
        # their matches are violations, not advances)
        ops: List[Tuple[StepSpec, SideSpec]] = [
            (st, side)
            for st in plan.steps
            for side in st.sides
            if side.stream_id == stream_id
        ]
        in_def = ops[0][1].definition if ops else None
        cap_names = list(self.cap_cols)
        cap_dt = {nm: _tdt(dt) for nm, dt in self.cap_cols.items()}
        arm_j = plan.arm_step()
        arm_capless = arm_j is not None and all(
            s.capture is None for s in plan.steps[arm_j].sides)
        ar = torch.arange(S, device=dev)

        out_valid = torch.zeros((B, S + 1), dtype=torch.bool, device=dev)
        out_caps = {nm: torch.zeros((B, S + 1), dtype=cap_dt[nm], device=dev)
                    for nm in cap_names}
        out_caps["__capdone__"] = torch.zeros((B, S + 1), dtype=torch.int32,
                                              device=dev)
        out_ts = ts[:, None].expand(B, S + 1).contiguous()
        ov0 = state["nfa_overflow"]
        overflow = ov0

        for lo, hi in bounds:
            R = rows_all[lo:hi]
            n = hi - lo
            pk_r = pk[R]
            ts_r = ts[R]
            ts2d = ts_r[:, None]
            rc: Dict[str, torch.Tensor] = {}

            def rcol(name, _R=R, _rc=rc):
                v = _rc.get(name)
                if v is None:
                    v = _rc[name] = cols[name][_R]
                return v

            def zeros2(dt=torch.bool):
                return torch.zeros((n, S), dtype=dt, device=dev)

            def capture_current(CP, CD, mask2d, cap: CaptureSpec):
                """Write the current event into a capture (last + indexed
                slot + counter) for slots selected by mask2d [n, S]."""
                cid = cap.cid
                if cap.last_ring:
                    # shift the ring BEFORE the new event overwrites
                    # `last`: L[j] <- L[j-1], L[1] <- old last
                    for jj in range(cap.last_ring, 0, -1):
                        for a in cap.definition.attributes:
                            src = (cap_lastk_col(cid, jj - 1, a.name) if jj > 1
                                   else cap_col(cid, a.name))
                            dst = cap_lastk_col(cid, jj, a.name)
                            CP[dst] = torch.where(mask2d, CP[src], CP[dst])
                            CP[dst + "?"] = torch.where(mask2d, CP[src + "?"],
                                                        CP[dst + "?"])
                for a in cap.definition.attributes:
                    nm = cap_col(cid, a.name)
                    CP[nm] = torch.where(mask2d, rcol(a.name)[:, None], CP[nm])
                    CP[nm + "?"] = torch.where(mask2d, rcol(a.name + "?")[:, None],
                                               CP[nm + "?"])
                nm = cap_col(cid, TS_KEY)
                CP[nm] = torch.where(mask2d, ts2d, CP[nm])
                if cap.is_count:
                    cnt_n = cap_cnt_col(cid)
                    before = CP[cnt_n]
                    for i in range(cap.n_idx):
                        sel = mask2d & (before == i)
                        for a in cap.definition.attributes:
                            ni = cap_idx_col(cid, i, a.name)
                            CP[ni] = torch.where(sel, rcol(a.name)[:, None], CP[ni])
                            CP[ni + "?"] = torch.where(
                                sel, rcol(a.name + "?")[:, None], CP[ni + "?"])
                    CP[cnt_n] = torch.where(mask2d, before + 1, CP[cnt_n])
                CD = torch.where(mask2d, CD | (1 << cid), CD)
                return CP, CD

            V = {
                "A": state["active"][pk_r],
                "ST": state["stepi"][pk_r],
                "BT": state["bits"][pk_r],
                "VB": state["vbits"][pk_r],
                "T0": state["sts"][pk_r],
                "ADL": state["adl"][pk_r],
                "AD2": state["adl2"][pk_r],
                "CD": state["capdone"][pk_r],
                "CP": {nm: state[nm][pk_r] for nm in cap_names},
                "SC": [state[g][pk_r] for g in self.scope_cols],
            }
            CONS = state["consumed"][pk_r]
            ARMD = state["armed"][pk_r]

            # ---- arming: a key's very first row arms the head wait. A
            # capture-LESS armed head (pure absent) starts `within` from
            # its FIRST CAPTURE, not from arming — T0 arms at a far-future
            # sentinel that every later capture min()s down to its ts
            if arm_j is not None:
                need = ~ARMD
                onehot0 = need[:, None] & (ar[None, :] == 0)
                V["A"] = V["A"] | onehot0
                V["T0"] = torch.where(
                    onehot0, int(_T0_FAR) if arm_capless else ts2d, V["T0"])
                V = self._enter(V, onehot0, arm_j, ts2d)
                ARMD = ARMD | need

            # ---- expiry + deadline cascade (before matching: a row at
            # ts past a deadline sees the advanced state)
            V = self._expire(V, ts2d)
            emit = zeros2()
            ets = ts2d.expand(n, S)
            fork_reqs: List = []
            V, emit, ets = self._cascade(V, ts2d, emit, ets, fork_reqs)

            A, ST, BT, VB, T0, CD = (V["A"], V["ST"], V["BT"], V["VB"],
                                     V["T0"], V["CD"])
            CP = V["CP"]

            # eval dict: current attrs [n,1], captures [n,S]. A count
            # capture with no occurrences yet reads NULL; `@present`
            # synthetics carry the bare StateEvent presence checks
            ev = dict(CP)
            ones2d = torch.ones((n, S), dtype=torch.bool, device=dev)
            pres_cols: List[str] = []

            def _pres(ev_d, name, absent):
                ev_d[name] = ones2d
                ev_d[name + "?"] = absent
                pres_cols.append(name)

            for cap in plan.captures:
                if not cap.is_count:
                    _pres(ev, cap_col(cap.cid, PRESENT),
                          (V["CD"] & (1 << cap.cid)) == 0)
                    continue
                cnt = CP[cap_cnt_col(cap.cid)]
                _pres(ev, cap_col(cap.cid, PRESENT), cnt == 0)
                for jj in range(1, cap.last_ring + 1):
                    _pres(ev, cap_lastk_col(cap.cid, jj, PRESENT), cnt <= jj)
                for i in range(cap.n_idx):
                    _pres(ev, cap_idx_col(cap.cid, i, PRESENT), cnt <= i)
                for a in cap.definition.attributes:
                    nm = cap_col(cap.cid, a.name) + "?"
                    ev[nm] = CP[nm] | (cnt == 0)
                    for jj in range(1, cap.last_ring + 1):
                        nj = cap_lastk_col(cap.cid, jj, a.name) + "?"
                        ev[nj] = CP[nj] | (cnt <= jj)
            if in_def is not None:
                for a in in_def.attributes:
                    ev[a.name] = rcol(a.name)[:, None]
                    ev[a.name + "?"] = rcol(a.name + "?")[:, None]
            ev[TS_KEY] = ts2d
            # fresh-start eval dict: capture references are NULL (a fresh
            # chain has captured nothing)
            ev_fresh = dict(ev)
            for nm in cap_names:
                if nm.endswith("?"):
                    ev_fresh[nm] = torch.ones((n, 1), dtype=ev[nm].dtype, device=dev)
                else:
                    ev_fresh[nm] = torch.zeros((n, 1), dtype=ev[nm].dtype, device=dev)
            for nm in pres_cols:
                ev_fresh[nm + "?"] = torch.ones((n, 1), dtype=torch.bool, device=dev)

            # ---- phase 1: match masks against pre-event state; the
            # furthest-advanced op wins a slot (no per-event forking)
            win = torch.full((n, S), -1, dtype=torch.int32, device=dev)
            at_masks: List[torch.Tensor] = []
            adv_masks: List[torch.Tensor] = []
            adv_fork_masks: List[List[Tuple[int, torch.Tensor]]] = []
            viols: List[torch.Tensor] = []
            for oi, (st, side) in enumerate(ops):
                j = st.index
                cond = (_as_mask(side.cond(ev, ctx), (n, S), dev)
                        if side.cond is not None else ones2d)
                if side.absent:
                    # a matching event on an absent side while the slot
                    # waits = violation (AbsentStreamPreStateProcessor)
                    v = A & (ST == j) & cond
                    if st.kind in ("and", "or"):
                        v = v & ((BT & side.bit) == 0)
                    viols.append(v)
                    at_masks.append(zeros2())
                    adv_masks.append(zeros2())
                    adv_fork_masks.append([])
                    continue
                viols.append(zeros2())
                at = A & (ST == j) & cond
                if st.kind == "count":
                    at = at & (CP[cap_cnt_col(side.capture.cid)] < st.max_count)
                elif st.kind in ("and", "or"):
                    # a side is consumed once (LogicalPreStateProcessor)
                    at = at & ((BT & side.bit) == 0)
                adv = zeros2()
                fork_all = zeros2()
                fork_srcs: List[Tuple[int, torch.Tensor]] = []
                for p in self._advance_sources(j):
                    src = plan.steps[p]
                    pc = CP[cap_cnt_col(src.sides[0].capture.cid)]
                    am = A & (ST == p) & (pc >= src.min_count)
                    if (src.kind == "count" and src.sticky
                            and src.min_count != src.max_count):
                        # range `every` count: group = whatever is
                        # collected when consumed; parent re-arms, child
                        # advances
                        fm = am & cond
                        fork_srcs.append((p, fm))
                        fork_all = fork_all | fm
                    else:
                        adv = adv | am
                adv = adv & cond
                at_masks.append(at)
                adv_masks.append(adv)
                adv_fork_masks.append(fork_srcs)
                claim = at | adv | fork_all
                if oi > 0 and ops[oi - 1][0] is st:
                    # sides of one logical step: the FIRST side wins when
                    # an event matches both
                    claim = claim & (win != oi - 1)
                win = torch.where(claim, oi, win)

            matched = win >= 0

            # ---- violations: kill / mark / re-arm
            A2, ST2, BT2, VB2, CD2 = A, ST, BT, VB, CD
            ADL2_, AD22_ = V["ADL"], V["AD2"]
            CP2 = dict(CP)
            for oi, (st, side) in enumerate(ops):
                if not side.absent:
                    continue
                v = viols[oi]
                if st.kind == "absent":
                    if st.sticky or st.index == arm_j:
                        # every-not restarts its interval; a HEAD wait
                        # re-inits after violation even without `every`
                        ADL2_ = torch.where(v, ts2d + st.wait_ms, ADL2_)
                    else:
                        A2 = A2 & ~v
                elif st.kind == "and":
                    if st.sticky:
                        BT2 = torch.where(v, 0, BT2)
                        VB2 = torch.where(v, 0, VB2)
                        if side.wait_ms is not None:
                            if side.bit == 1:
                                ADL2_ = torch.where(v, ts2d + side.wait_ms, ADL2_)
                            else:
                                AD22_ = torch.where(v, ts2d + side.wait_ms, AD22_)
                    else:
                        A2 = A2 & ~v       # `and` with a violated absent side is dead
                else:  # or
                    VB2 = torch.where(v, VB2 | side.bit, VB2)
                    if all(s.absent for s in st.sides):
                        dead = (VB2 & st.need_bits) == st.need_bits
                        A2 = A2 & ~(v & dead)

            # ---- phase 2: apply the winning transition per slot
            emit2 = zeros2()
            kill = zeros2()
            sticky_emit_ops: List[Tuple[torch.Tensor, StepSpec, SideSpec]] = []
            phase2_forks: List[Tuple[torch.Tensor, int, Optional[SideSpec]]] = []
            count_resets: List[Tuple[torch.Tensor, StepSpec]] = []
            SC = V["SC"]
            for oi, (st, side) in enumerate(ops):
                if side.absent:
                    continue
                j = st.index
                eff_at = at_masks[oi] & (win == oi)
                eff_adv = adv_masks[oi] & (win == oi)
                if (st.kind == "and" and oi > 0 and ops[oi - 1][0] is st
                        and not ops[oi - 1][1].absent):
                    # ONE event matching BOTH `and` sides fills both
                    # captures in the same round
                    both = (win == oi) | (win == oi - 1)
                    eff_at = at_masks[oi] & both
                    eff_adv = adv_masks[oi] & both
                eff = eff_at | eff_adv
                cap = side.capture
                for p, fmask in adv_fork_masks[oi]:
                    fm = fmask & (win == oi)
                    count_resets.append((fm, plan.steps[p]))
                    if j == L:
                        sticky_emit_ops.append((fm, st, side))
                    else:
                        phase2_forks.append((fm, j + 1, side))
                if st.sticky and st.kind == "stream":
                    # sticky step: parent stays; fork an advanced child,
                    # for a mid-chain `every (...)` GROUP only while no
                    # earlier child is still INSIDE the group span
                    gend = plan.every_groups.get(j)
                    if gend is not None and gend > j:
                        busy = (A & (ST > j) & (ST <= gend)).any(dim=1)
                        eff = eff & ~busy[:, None]
                    if j == L:
                        sticky_emit_ops.append((eff, st, side))
                    else:
                        phase2_forks.append((eff, j + 1, side))
                    continue
                if st.kind == "count":
                    CP2, CD2 = capture_current(CP2, CD2, eff, cap)
                    if arm_capless:
                        T0 = torch.where(eff, torch.minimum(T0, ts2d), T0)
                    ST2 = torch.where(eff, j, ST2)
                    if (j < L and not st.sticky
                            and st.min_count == st.max_count):
                        # a FULL exact count advances into the next step
                        # immediately (reference processMinCountReached)
                        done = eff & (CP2[cap_cnt_col(cap.cid)] >= st.max_count)
                        tmp = {"ST": ST2, "BT": BT2, "VB": VB2,
                               "ADL": ADL2_, "AD2": AD22_, "CD": CD2,
                               "SC": list(SC)}
                        tmp = self._enter(tmp, done, j + 1, ts2d)
                        ST2, BT2, VB2 = tmp["ST"], tmp["BT"], tmp["VB"]
                        ADL2_, AD22_, CD2 = tmp["ADL"], tmp["AD2"], tmp["CD"]
                        SC = tmp["SC"]
                    if j == L:
                        done = eff & (CP2[cap_cnt_col(cap.cid)] >= st.min_count)
                        emit2 = emit2 | done
                        if st.sticky:
                            # `every` count tail: emit each completed group
                            # and re-arm a fresh collection
                            count_resets.append((done, st))
                    elif st.sticky and st.min_count == st.max_count:
                        # exact `every` count mid-chain: a completed group
                        # forks a waiting child; the parent restarts
                        done = eff & (CP2[cap_cnt_col(cap.cid)] >= st.max_count)
                        phase2_forks.append((done, j, None))
                        count_resets.append((done, st))
                elif st.kind == "stream":
                    CP2, CD2 = capture_current(CP2, CD2, eff, cap)
                    if arm_capless:
                        T0 = torch.where(eff, torch.minimum(T0, ts2d), T0)
                    if j == L:
                        emit2 = emit2 | eff
                        kill = kill | eff
                    else:
                        tmp = {"ST": ST2, "BT": BT2, "VB": VB2,
                               "ADL": ADL2_, "AD2": AD22_, "CD": CD2, "SC": SC}
                        tmp = self._enter(tmp, eff, j + 1, ts2d)
                        ST2, BT2, VB2 = tmp["ST"], tmp["BT"], tmp["VB"]
                        ADL2_, AD22_, CD2 = tmp["ADL"], tmp["AD2"], tmp["CD"]
                        if j + 1 >= plan.eager_tail_start:
                            # the rest of the chain is all min-0 counts:
                            # already complete — emit now, keep absorbing
                            emit2 = emit2 | eff
                else:  # and / or
                    CP2, CD2 = capture_current(CP2, CD2, eff, cap)
                    if arm_capless:
                        T0 = torch.where(eff, torch.minimum(T0, ts2d), T0)
                    bt2 = torch.where(eff, BT2 | side.bit, BT2)
                    nb = st.need_bits
                    full = ((bt2 & nb) == nb) if st.kind == "and" else ones2d
                    done = eff & full
                    if st.sticky:
                        # re-arm the logical parent on completion
                        if j == L:
                            emit2 = emit2 | done
                        else:
                            phase2_forks.append((done, j + 1, None))
                        BT2 = torch.where(eff & ~done, bt2,
                                          torch.where(done, 0, BT2))
                        VB2 = torch.where(done, 0, VB2)
                        for s2 in st.sides:
                            if s2.absent and s2.wait_ms is not None:
                                if s2.bit == 1:
                                    ADL2_ = torch.where(done, ts2d + s2.wait_ms, ADL2_)
                                else:
                                    AD22_ = torch.where(done, ts2d + s2.wait_ms, AD22_)
                        continue
                    if j == L:
                        emit2 = emit2 | done
                        kill = kill | done
                    else:
                        tmp = {"ST": ST2, "BT": BT2, "VB": VB2,
                               "ADL": ADL2_, "AD2": AD22_, "CD": CD2, "SC": SC}
                        tmp = self._enter(tmp, done, j + 1, ts2d)
                        ST2, BT2, VB2 = tmp["ST"], tmp["BT"], tmp["VB"]
                        ADL2_, AD22_, CD2 = tmp["ADL"], tmp["AD2"], tmp["CD"]
                    BT2 = torch.where(eff & ~done, bt2, BT2)
                    ST2 = torch.where(eff & ~full, j, ST2)

            # scope starts for plain capture steps
            scV = {"CD": CD2, "SC": SC}
            for oi, (st, side) in enumerate(ops):
                if side.absent or st.sticky:
                    continue
                eff = (at_masks[oi] | adv_masks[oi]) & (win == oi)
                scV = self._start_capture_scopes(scV, eff, st.index, ts2d)
            CD2, SC = scV["CD"], scV["SC"]

            if plan.sequence:
                # strict continuity kills unmatched partials — but not
                # slots WAITING at an absent-ish step
                at_waitish = torch.zeros_like(A)
                for wst in plan.steps:
                    if wst.waitish:
                        at_waitish = at_waitish | (ST == wst.index)
                kill = kill | (A & ~matched & ~at_waitish)
            A2 = A2 & ~kill

            emit_all = emit | emit2
            ets = torch.where(emit2, ts2d, ets)

            # ---- sticky emissions at the last step: emit parent captures
            # + the current event, parent survives
            CPe = None
            semit = zeros2()
            for eff, st, side in sticky_emit_ops:
                if CPe is None:
                    CPe, CDe = dict(CP2), CD2
                CPe, CDe = capture_current(CPe, CDe, eff, side.capture)
                semit = semit | eff
            emit_all = emit_all | semit

            # ---- emission snapshot BEFORE fork allocation: forks may
            # reuse slots freed by emitting matches
            out_cd = torch.where(emit_all, CD2, 0)
            ov2 = {nm: torch.where(emit_all, CP2[nm], torch.zeros(
                (), dtype=cap_dt[nm], device=dev)) for nm in cap_names}
            if CPe is not None:
                ov2 = {nm: torch.where(semit, CPe[nm], v) for nm, v in ov2.items()}
                out_cd = torch.where(semit, CDe, out_cd)
            row_ts = torch.where(emit_all, ets, ts2d)

            # ---- allocate forked children (sticky advances)
            V2 = {"A": A2, "ST": ST2, "BT": BT2, "VB": VB2, "T0": T0,
                  "ADL": ADL2_, "AD2": AD22_, "CD": CD2, "CP": CP2, "SC": SC}
            for req, target, arm_ts in fork_reqs:
                V2, dstm, overflow = self._alloc_forks(V2, req, overflow)
                V2 = self._enter(V2, dstm, target, _gather_like(arm_ts, req, dstm))
            for req, target, side in phase2_forks:
                V2, dstm, overflow = self._alloc_forks(V2, req, overflow)
                if side is not None and side.capture is not None:
                    V2["CP"], V2["CD"] = capture_current(
                        V2["CP"], V2["CD"], dstm, side.capture)
                V2 = self._enter(V2, dstm, target, ts2d)
                V2 = self._start_capture_scopes(V2, dstm, target - 1, ts2d)
            A2, ST2, BT2, VB2 = V2["A"], V2["ST"], V2["BT"], V2["VB"]
            T0, ADL2_, AD22_, CD2 = V2["T0"], V2["ADL"], V2["AD2"], V2["CD"]
            CP2, SC2 = V2["CP"], V2["SC"]

            # ---- re-arm sticky (`every`) count parents: zero the counter,
            # the collected capture arrays, and any capture scope anchored
            # at the count step (after the emission snapshot and fork copies)
            for fm, src_st in count_resets:
                scap = src_st.sides[0].capture
                cnt_col = cap_cnt_col(scap.cid)
                pref, prefi = f"c{scap.cid}__", f"c{scap.cid}i"
                for nm in cap_names:
                    if nm == cnt_col or nm.startswith(pref) or nm.startswith(prefi):
                        clear = torch.full((), nm.endswith("?"),
                                           dtype=cap_dt[nm], device=dev)
                        CP2[nm] = torch.where(fm, clear, CP2[nm])
                for g, (a, b, t) in enumerate(plan.scopes):
                    if a == src_st.index and not plan.steps[a].waitish:
                        CD2 = torch.where(fm, CD2 & ~plan.scope_bit(g), CD2)

            # ---- fresh starts
            every_ok = (torch.ones_like(CONS) if plan.every else ~CONS)
            if plan.rearm_on_empty:
                # count-head non-every: the start state re-arms once no
                # chain is live (post-match / post-expiry)
                every_ok = every_ok | ~A.any(dim=1)
            head_gend = plan.every_groups.get(0)
            if plan.every and head_gend is not None and (
                    head_gend > 0 or plan.steps[0].kind in ("and", "or")):
                in_head_group = (A & (ST <= head_gend)).any(dim=1)
            else:
                in_head_group = None
            # SEQUENCE: an event absorbed into an ONGOING count collection
            # belongs to that chain alone — it must not also seed a fresh
            # `every` iteration
            seq_absorbing = None
            if plan.sequence and plan.every:
                for oi2, (st2, side2) in enumerate(ops):
                    if (st2.kind == "count" and not side2.absent
                            and st2.index < plan.eager_tail_start):
                        t = (at_masks[oi2] & (win == oi2)).any(dim=1)
                        seq_absorbing = t if seq_absorbing is None else seq_absorbing | t
            fresh_any = torch.zeros(n, dtype=torch.bool, device=dev)
            direct = torch.zeros(n, dtype=torch.bool, device=dev)
            direct_op = torch.full((n,), -1, dtype=torch.int32, device=dev)
            fresh_reqs: List[Tuple[torch.Tensor, int, int, SideSpec]] = []
            for oi, (st, side) in enumerate(ops):
                if side.absent:
                    continue
                j = st.index
                if not self._fresh_ok(j):
                    continue
                fcond = (_as_mask(side.cond(ev_fresh, ctx), (n, 1), dev)[:, 0]
                         if side.cond is not None else True)
                f = every_ok & fcond
                if seq_absorbing is not None:
                    f = f & ~seq_absorbing
                if in_head_group is not None and j <= head_gend:
                    f = f & ~in_head_group

                if st.kind == "count":
                    # non-overlapping `every` collections: an event some
                    # slot absorbed does not also seed a fresh instance
                    f = f & ~(at_masks[oi] & (win == oi)).any(dim=1)
                    if j == L and 1 >= st.min_count:
                        direct, direct_op = _mark_direct(direct, direct_op, f, oi)
                    if j < L or 1 < st.max_count:
                        fresh_reqs.append((f, j, 0, side))       # park at j
                elif st.kind == "stream":
                    if j == L and not st.sticky:
                        direct, direct_op = _mark_direct(direct, direct_op, f, oi)
                    elif st.sticky:
                        # a sticky head is plan.every — fresh slots park AT it
                        fresh_reqs.append((f, j, 0, side))
                    else:
                        fresh_reqs.append((f, j + 1, 0, side))   # rest past j
                        if j + 1 >= plan.eager_tail_start:
                            # everything after j is a min-0 count: emit now
                            # AND park the slot to keep absorbing
                            direct, direct_op = _mark_direct(direct, direct_op, f, oi)
                else:  # logical
                    full0 = st.kind == "or"
                    if full0 and j == L:
                        direct, direct_op = _mark_direct(direct, direct_op, f, oi)
                    elif full0:
                        fresh_reqs.append((f, j + 1, 0, side))
                    else:
                        fresh_reqs.append((f, j, side.bit, side))
                fresh_any = fresh_any | f

            # ---- allocate fresh slots
            if fresh_reqs:
                req = torch.stack([fr[0] for fr in fresh_reqs], dim=1)  # [n, NF]
                free = ~A2
                n_free = free.sum(dim=1)
                fs = torch.argsort(torch.where(free, ar, S + ar), dim=1, stable=True)
                rank = torch.cumsum(req.to(torch.int64), dim=1) - 1
                can = req & (rank < n_free[:, None])
                overflow = overflow + (req & ~can).sum().to(torch.int32)
                slot_of = torch.where(
                    can, torch.gather(fs, 1, rank.clamp(0, S - 1)), S)
                for k, (f, step_val, bits_val, side) in enumerate(fresh_reqs):
                    onehot = slot_of[:, k:k + 1] == ar[None, :]
                    cap = side.capture
                    A2 = A2 | onehot
                    T0 = torch.where(onehot, ts2d, T0)
                    # clear the new slot's captures (masks to NULL), then
                    # capture the event
                    for nm in cap_names:
                        clear = torch.full((), nm.endswith("?"),
                                           dtype=cap_dt[nm], device=dev)
                        CP2[nm] = torch.where(onehot, clear, CP2[nm])
                    CD2 = torch.where(onehot, 0, CD2)
                    tmp = {"ST": ST2, "BT": BT2, "VB": VB2,
                           "ADL": ADL2_, "AD2": AD22_, "CD": CD2, "SC": SC2}
                    tmp = self._enter(tmp, onehot, step_val, ts2d)
                    ST2, BT2, VB2 = tmp["ST"], tmp["BT"], tmp["VB"]
                    ADL2_, AD22_, CD2, SC2 = (tmp["ADL"], tmp["AD2"],
                                              tmp["CD"], tmp["SC"])
                    BT2 = torch.where(onehot, bits_val, BT2)
                    if cap is not None:
                        CP2, CD2 = capture_current(CP2, CD2, onehot, cap)
                        scV2 = self._start_capture_scopes(
                            {"CD": CD2, "SC": SC2}, onehot,
                            fresh_cap_step(plan, step_val, bits_val), ts2d)
                        CD2, SC2 = scV2["CD"], scV2["SC"]

            # ---- direct-emission column (fresh match completing instantly)
            ov3 = {}
            for nm in cap_names:
                col_S = torch.zeros(n, dtype=cap_dt[nm], device=dev)
                for oi, (st, side) in enumerate(ops):
                    cap = side.capture
                    if cap is None:
                        continue
                    dm = direct & (direct_op == oi)
                    base = None
                    if nm == cap_col(cap.cid, TS_KEY):
                        col_S = torch.where(dm, ts_r, col_S)
                    elif cap.is_count and nm == cap_cnt_col(cap.cid):
                        col_S = torch.where(dm, 1, col_S)
                    elif nm.startswith(f"c{cap.cid}__"):
                        base = nm[len(f"c{cap.cid}__"):]
                    elif nm.startswith(f"c{cap.cid}i0__"):
                        base = nm[len(f"c{cap.cid}i0__"):]
                    if base is not None and base in cols:
                        col_S = torch.where(dm, rcol(base), col_S)
                ov3[nm] = torch.cat([ov2[nm], col_S[:, None]], dim=1)
            direct_cd = torch.zeros(n, dtype=torch.int32, device=dev)
            for oi, (st, side) in enumerate(ops):
                if side.capture is None:
                    continue
                dm = direct & (direct_op == oi)
                direct_cd = torch.where(dm, 1 << side.capture.cid, direct_cd)
            ov3["__capdone__"] = torch.cat([out_cd, direct_cd[:, None]], dim=1)

            # ---- this round's rows of the emission, and its keys' state
            out_valid.index_copy_(0, R, torch.cat([emit_all, direct[:, None]], dim=1))
            out_ts.index_copy_(0, R, torch.cat([row_ts, ts2d], dim=1))
            for nm, v in ov3.items():
                out_caps[nm].index_copy_(0, R, v)

            def put(name, view):
                state[name].index_copy_(0, pk_r, view)

            put("active", A2)
            put("stepi", ST2)
            put("bits", BT2)
            put("vbits", VB2)
            put("sts", T0)
            put("adl", ADL2_)
            put("adl2", AD22_)
            put("capdone", CD2)
            put("consumed", CONS | fresh_any | direct)
            if arm_j is not None:
                put("armed", ARMD)
            for nm in cap_names:
                put(nm, CP2[nm])
            for g, name in enumerate(self.scope_cols):
                put(name, SC2[g])

        state["nfa_overflow"] = overflow
        out = self._flatten_out(out_valid, out_caps, out_ts, cols, pk32, B)
        out["__overflow__"] = (overflow > ov0).to(torch.int32)
        out["__notify__"] = self._notify(state)
        return state, out

    # ................................................ scheduler TIMER sweep

    def apply_timer(self, state: dict, now, ctx: dict):
        """Advance every key's waiting slots whose deadlines have passed
        (the role of the reference scheduler posting TIMER events through
        AbsentStreamPreStateProcessor). Emissions flatten to [K*S]."""
        self.timer_steps += 1
        plan = self.plan
        S = plan.slots
        K = state["consumed"].shape[0]
        dev = state["active"].device
        cap_names = list(self.cap_cols)
        ts2d = torch.full((K, S), int(now), dtype=torch.int64, device=dev)

        V = {
            "A": state["active"],
            "ST": state["stepi"],
            "BT": state["bits"],
            "VB": state["vbits"],
            "T0": state["sts"],
            "ADL": state["adl"],
            "AD2": state["adl2"],
            "CD": state["capdone"],
            "CP": {nm: state[nm] for nm in cap_names},
            "SC": [state[g] for g in self.scope_cols],
        }
        V = self._expire(V, ts2d)
        emit = torch.zeros((K, S), dtype=torch.bool, device=dev)
        ets = ts2d
        fork_reqs: List = []
        V, emit, ets = self._cascade(V, ts2d, emit, ets, fork_reqs)
        # emission snapshot before forks (forks may reuse freed slots)
        emit_CP = dict(V["CP"])
        emit_CD = V["CD"]
        ov0 = state["nfa_overflow"]
        overflow = ov0
        for req, target, arm_ts in fork_reqs:
            V, dstm, overflow = self._alloc_forks(V, req, overflow)
            V = self._enter(V, dstm, target, _gather_like(arm_ts, req, dstm))

        state.update(active=V["A"], stepi=V["ST"], bits=V["BT"],
                     vbits=V["VB"], sts=V["T0"], adl=V["ADL"],
                     adl2=V["AD2"], capdone=V["CD"], nfa_overflow=overflow)
        for g, name in enumerate(self.scope_cols):
            state[name] = V["SC"][g]
        for nm in cap_names:
            state[nm] = V["CP"][nm]

        # flatten [K, S] emissions
        N = K * S
        out: Dict[str, torch.Tensor] = {}
        cd_flat = torch.where(emit, emit_CD, 0).reshape(N)
        for cap in plan.captures:
            got = (cd_flat & (1 << cap.cid)) != 0
            cnt_flat = (emit_CP[cap_cnt_col(cap.cid)].reshape(N)
                        if cap.is_count else None)
            for a in cap.definition.attributes:
                nm = cap_col(cap.cid, a.name)
                out[nm] = emit_CP[nm].reshape(N)
                out[nm + "?"] = emit_CP[nm + "?"].reshape(N) | ~got
                for i in range(cap.n_idx):
                    ni = cap_idx_col(cap.cid, i, a.name)
                    out[ni] = emit_CP[ni].reshape(N)
                    out[ni + "?"] = (emit_CP[ni + "?"].reshape(N) | ~got
                                     | (cnt_flat <= i))
                for jj in range(1, cap.last_ring + 1):
                    nj = cap_lastk_col(cap.cid, jj, a.name)
                    out[nj] = emit_CP[nj].reshape(N)
                    out[nj + "?"] = (emit_CP[nj + "?"].reshape(N) | ~got
                                     | (cnt_flat <= jj))
            nm = cap_col(cap.cid, TS_KEY)
            out[nm] = emit_CP[nm].reshape(N)
            if cap.is_count:
                out[cap_cnt_col(cap.cid)] = cnt_flat
            _emit_last_cols(out, cap, lambda k: emit_CP[k].reshape(N), got,
                            cnt_flat)
            _emit_present_cols(out, cap, got, cnt_flat, N, dev)
        out[VALID_KEY] = emit.reshape(N)
        out[TS_KEY] = ets.reshape(N)
        out[TYPE_KEY] = torch.zeros(N, dtype=torch.int8, device=dev)
        pk_flat = torch.repeat_interleave(
            torch.arange(K, dtype=torch.int32, device=dev), S)
        out["__gk__"] = pk_flat
        out[PK_KEY] = pk_flat
        out["__overflow__"] = (overflow > ov0).to(torch.int32)
        out["__notify__"] = self._notify(state)
        return state, out

    # ......................................................... output shape

    def _flatten_out(self, out_valid, out_caps, out_ts, cols, pk32, B):
        """Flatten [B, S+1] emissions row-major (event order, slot order)."""
        S = self.plan.slots
        N = B * (S + 1)
        dev = out_valid.device
        out: Dict[str, torch.Tensor] = {}
        capdone_flat = out_caps["__capdone__"].reshape(N)
        for cap in self.plan.captures:
            got = (capdone_flat & (1 << cap.cid)) != 0
            cnt_flat = (out_caps[cap_cnt_col(cap.cid)].reshape(N)
                        if cap.is_count else None)
            for a in cap.definition.attributes:
                nm = cap_col(cap.cid, a.name)
                out[nm] = out_caps[nm].reshape(N)
                out[nm + "?"] = out_caps[nm + "?"].reshape(N) | ~got
                for i in range(cap.n_idx):
                    ni = cap_idx_col(cap.cid, i, a.name)
                    out[ni] = out_caps[ni].reshape(N)
                    out[ni + "?"] = (out_caps[ni + "?"].reshape(N) | ~got
                                     | (cnt_flat <= i))
                for jj in range(1, cap.last_ring + 1):
                    nj = cap_lastk_col(cap.cid, jj, a.name)
                    out[nj] = out_caps[nj].reshape(N)
                    out[nj + "?"] = (out_caps[nj + "?"].reshape(N) | ~got
                                     | (cnt_flat <= jj))
            nm = cap_col(cap.cid, TS_KEY)
            out[nm] = out_caps[nm].reshape(N)
            if cap.is_count:
                out[cap_cnt_col(cap.cid)] = cnt_flat
            _emit_last_cols(out, cap, lambda k: out_caps[k].reshape(N), got,
                            cnt_flat)
            _emit_present_cols(out, cap, got, cnt_flat, N, dev)
        out[VALID_KEY] = out_valid.reshape(N)
        out[TS_KEY] = out_ts.reshape(N)
        out[TYPE_KEY] = torch.zeros(N, dtype=torch.int8, device=dev)  # CURRENT
        out["__gk__"] = torch.repeat_interleave(cols.get("__gk__", pk32), S + 1)
        if PK_KEY in cols:
            out[PK_KEY] = torch.repeat_interleave(cols[PK_KEY], S + 1)
        return out


def _emit_last_cols(out: Dict, cap: CaptureSpec, flat_of, got, cnt_flat):
    """Materialize ``e[last - k]`` derived columns: the value at runtime
    position cnt-1-k selected across the capture's indexed slots. Open
    counts (cap.last_ring) emit from ring columns instead — never here."""
    if not cap.last_offsets or cnt_flat is None or cap.last_ring:
        return
    for k in sorted(cap.last_offsets):
        pos = cnt_flat - 1 - k
        for a in cap.definition.attributes:
            acc = None
            mk = None
            for i in range(cap.n_idx):
                sel = pos == i
                v = flat_of(cap_idx_col(cap.cid, i, a.name))
                m = flat_of(cap_idx_col(cap.cid, i, a.name) + "?")
                # rows whose pos matches no slot keep slot 0's value but
                # are nulled by the pos<0 / ~got mask below
                acc = v if acc is None else torch.where(sel, v, acc)
                mk = m if mk is None else torch.where(sel, m, mk)
            if acc is None:
                continue
            out[cap_last_col(cap.cid, k, a.name)] = acc
            out[cap_last_col(cap.cid, k, a.name) + "?"] = (
                mk | ~got | (pos < 0))


def _emit_present_cols(out: Dict, cap: CaptureSpec, got, cnt_flat, N: int, dev):
    """`@present` synthetics on emitted rows: null mask = StateEvent
    absence (bare `e2 is null` / `e2[last-k] is null` in selectors)."""
    ones = torch.ones(N, dtype=torch.bool, device=dev)
    out[cap_col(cap.cid, PRESENT)] = ones
    out[cap_col(cap.cid, PRESENT) + "?"] = (
        ~got if cnt_flat is None else ~got | (cnt_flat == 0))
    if cnt_flat is None:
        return
    for i in range(cap.n_idx):
        out[cap_idx_col(cap.cid, i, PRESENT)] = ones
        out[cap_idx_col(cap.cid, i, PRESENT) + "?"] = ~got | (cnt_flat <= i)
    for j in range(1, cap.last_ring + 1):
        out[cap_lastk_col(cap.cid, j, PRESENT)] = ones
        out[cap_lastk_col(cap.cid, j, PRESENT) + "?"] = ~got | (cnt_flat <= j)
    if not cap.last_ring:
        for k in sorted(cap.last_offsets):
            out[cap_last_col(cap.cid, k, PRESENT)] = ones
            out[cap_last_col(cap.cid, k, PRESENT) + "?"] = (
                ~got | (cnt_flat - 1 - k < 0))


def _mark_direct(direct, direct_op, f, oi: int):
    """Rows ``f`` complete a match on a fresh event (the spare column);
    the first op to do so for a row is the one whose capture it emits."""
    return direct | f, torch.where(f & (direct_op < 0), oi, direct_op)


def fresh_cap_step(plan: NFAPlan, rest_step: int, bits_val: int) -> int:
    """The step whose event a fresh slot captured: rest-past slots captured
    step rest-1; park-at slots (counts, logical sides) captured rest."""
    if bits_val != 0:
        return rest_step
    if rest_step > 0 and plan.steps[rest_step - 1].kind == "stream":
        return rest_step - 1
    return rest_step


def _gather_like(arm_ts, req, dst_mask):
    """Move per-source-slot arm timestamps to their allocated destination
    slots: within a row, sources and destinations pair in slot-rank order,
    and `_alloc_forks` preserves rank, so a rank-aligned sort suffices."""
    n, S = req.shape
    idx = torch.arange(S, device=req.device)[None, :]
    src_key = torch.where(req, idx, S + idx)
    arm_ts = arm_ts.expand(n, S)
    src_sorted = torch.gather(arm_ts, 1, torch.argsort(src_key, dim=1, stable=True))
    rank_dst = torch.cumsum(dst_mask.to(torch.int64), dim=1) - 1
    vals = torch.gather(src_sorted, 1, rank_dst.clamp(0, S - 1))
    return torch.where(dst_mask, vals, 0)
