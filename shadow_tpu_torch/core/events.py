"""Event records and bounded per-host event queues, struct-of-arrays.

The counterpart of `shadow_tpu.core.events`. Every host's queue is a
fixed-capacity slot array, and all hosts' queues form [H, C] tensors.
Rows keep a sorted invariant: slots are ordered by the event key
(time, src, seq), with empty slots (time == TIME_INVALID) at the end.
A push groups the incoming events by destination with one flat sort,
finds each destination's run with one searchsorted, and merges each
run into its row with the fused merge (`core.merge`); overflow drops
the largest keys and counts them in `drops`, or, when the queue carries
a `SpillRing`, lands them in the ring for the host-side reservoir
(`runtime.pressure`) to harvest and re-insert at window boundaries.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from shadow_tpu_torch.core import merge
from shadow_tpu_torch.core.timebase import TIME_INVALID

N_ARGS = 6

# Common-round block width for queue_push: covers every per-destination
# per-sweep count a steady-state workload produces; rarer bursts take
# the exact full-width fallback round.
MERGE_W = 24

# Hot-region width for the row-wise merge: when every row's resident
# population plus the incoming block fits inside the first HOT_C
# columns, the merge touches only [H, HOT_C + W].
HOT_C = 128


@dataclasses.dataclass(frozen=True)
class Events:
    """A batch of event records (any leading shape).

    time: i64[...]  absolute sim time (TIME_INVALID = empty)
    dst:  i32[...]  destination (global) host id
    src:  i32[...]  source (global) host id
    seq:  i32[...]  per-source sequence number (tie-break)
    kind: i32[...]  handler index
    args: i32[..., N_ARGS] payload words
    """

    time: torch.Tensor
    dst: torch.Tensor
    src: torch.Tensor
    seq: torch.Tensor
    kind: torch.Tensor
    args: torch.Tensor

    def flatten(self) -> "Events":
        """Collapse the batch dims into one; args keeps its last dim."""
        nb = self.time.dim()
        return Events(**{
            f.name: getattr(self, f.name).reshape(
                (-1,) + tuple(getattr(self, f.name).shape[nb:]))
            for f in dataclasses.fields(self)
        })


@dataclasses.dataclass(frozen=True)
class SpillRing:
    """Per-host overflow ring: events evicted by `queue_push` land here,
    in eviction order, for the host-side reservoir to harvest.

    `wr` counts the events offered since the last reset; a record lands
    at min(wr, cap), so a full ring's writes fall into `slack` scratch
    columns (as wide as the widest single eviction, the queue capacity)
    that the harvester never reads. Events past a full ring are the only
    ones lost under spill, counted in `n_lost` and in the queue's
    `drops`. The payload rides packed as inside `queue_push` (kind +
    args as i64 word pairs).
    """

    time: torch.Tensor  # i64[H, cap + slack]
    srcseq: torch.Tensor  # i64[H, cap + slack] pack_srcseq(src, seq)
    pay: torch.Tensor  # i64[H, cap + slack, NW] packed kind+args words
    wr: torch.Tensor  # i32[H] events offered since the last reset
    n_spilled: torch.Tensor  # i64[H] events evicted into the ring
    n_lost: torch.Tensor  # i64[H] events lost to ring overflow
    fill_hwm: torch.Tensor  # i32[H] high-water mark of queue fill

    @staticmethod
    def create(n_hosts: int, cap: int, slack: int, n_args: int = N_ARGS,
               *, device) -> "SpillRing":
        nw = (1 + n_args + 1) // 2  # payload words, packed two per i64
        width = cap + slack
        z64 = lambda *s: torch.zeros(s, dtype=torch.int64, device=device)
        return SpillRing(
            time=torch.full((n_hosts, width), TIME_INVALID,
                            dtype=torch.int64, device=device),
            srcseq=z64(n_hosts, width), pay=z64(n_hosts, width, nw),
            wr=torch.zeros((n_hosts,), dtype=torch.int32, device=device),
            n_spilled=z64(n_hosts), n_lost=z64(n_hosts),
            fill_hwm=torch.zeros((n_hosts,), dtype=torch.int32,
                                 device=device),
        )


@dataclasses.dataclass(frozen=True)
class EventQueue:
    """All hosts' bounded event queues: [H, C] slot tensors.

    A slot is empty iff time == TIME_INVALID. `drops` counts events lost
    to queue overflow per host. `spill` is None (no leaves) unless the
    queue was created with an overflow ring.
    """

    time: torch.Tensor  # i64[H, C]
    src: torch.Tensor  # i32[H, C]
    seq: torch.Tensor  # i32[H, C]
    kind: torch.Tensor  # i32[H, C]
    args: torch.Tensor  # i32[H, C, N_ARGS]
    drops: torch.Tensor  # i64[H]
    spill: Any = None  # SpillRing, or None when spill is off

    @staticmethod
    def create(n_hosts: int, capacity: int, n_args: int = N_ARGS,
               spill: int = 0, *, device) -> "EventQueue":
        z = lambda *s: torch.zeros(s, dtype=torch.int32, device=device)
        return EventQueue(
            time=torch.full((n_hosts, capacity), TIME_INVALID,
                            dtype=torch.int64, device=device),
            src=z(n_hosts, capacity),
            seq=z(n_hosts, capacity),
            kind=z(n_hosts, capacity),
            args=z(n_hosts, capacity, n_args),
            drops=torch.zeros((n_hosts,), dtype=torch.int64, device=device),
            # slack = capacity: a merge round evicts at most w <= C events
            # per host in one append
            spill=(SpillRing.create(n_hosts, spill, capacity, n_args,
                                    device=device)
                   if spill > 0 else None),
        )

    def min_time(self) -> torch.Tensor:
        """Earliest pending event time per host (TIME_INVALID if empty)."""
        return self.time.min(dim=1).values


_FIELD_NAMES: dict = {}  # dataclass type -> its field names


def _field_names(cls) -> tuple:
    names = _FIELD_NAMES.get(cls)
    if names is None:
        names = _FIELD_NAMES[cls] = tuple(
            f.name for f in dataclasses.fields(cls))
    return names


def _select_rows(mask: torch.Tensor, new: Any, old: Any) -> Any:
    """Per-row select across two dataclasses of [H, ...] tensors: `new`
    where the [H] mask is set, else `old`. Nested dataclasses and tuples
    recurse and None fields stay None, as a pytree map over both would;
    a leaf that is the same tensor on both sides is kept without a
    select. The state dataclasses run no `__post_init__`, so a result is
    built field by field without `dataclasses.replace`'s checks: this
    runs for every host-state leaf at every handler of every step."""
    views: dict = {}  # the mask viewed at each leaf rank

    def sel(n, o):
        if o is None or n is o:
            return o
        if isinstance(o, torch.Tensor):
            m = views.get(o.dim())
            if m is None:
                m = views[o.dim()] = mask.reshape(
                    mask.shape + (1,) * (o.dim() - 1))
            return torch.where(m, n, o)
        if isinstance(o, tuple):
            return tuple(sel(a, b) for a, b in zip(n, o))
        out = object.__new__(type(o))
        out.__dict__.update({k: sel(getattr(n, k), getattr(o, k))
                             for k in _field_names(type(o))})
        return out

    return sel(new, old)


def group_run_starts(sorted_group_ids: torch.Tensor) -> torch.Tensor:
    """Index where each position's group run begins, for a group-sorted
    1-D tensor. Subtracting it from the position index yields each
    element's rank within its group."""
    n = sorted_group_ids.shape[0]
    pos = torch.arange(n, dtype=torch.int32, device=sorted_group_ids.device)
    boundary = torch.ones(n, dtype=torch.bool, device=pos.device)
    boundary[1:] = sorted_group_ids[1:] != sorted_group_ids[:-1]
    return torch.cummax(torch.where(boundary, pos, 0), dim=0).values


def pack_srcseq(src: torch.Tensor, seq: torch.Tensor) -> torch.Tensor:
    """Pack (src, seq) into one i64 preserving lexicographic order; seq is
    taken as uint32 so a negative value cannot reach the src bits."""
    return (src.to(torch.int64) << 32) | (seq.to(torch.int64) & 0xFFFFFFFF)


def unpack_srcseq(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return (p >> 32).to(torch.int32), (p & 0xFFFFFFFF).to(torch.int32)


def _pack_words(words):
    """i32 words -> i64 words, two per word (high first)."""
    out = []
    for i in range(0, len(words), 2):
        hi = words[i].to(torch.int64) << 32
        if i + 1 < len(words):
            hi = hi | (words[i + 1].to(torch.int64) & 0xFFFFFFFF)
        out.append(hi)
    return out


def _unpack_words(packed, n):
    words = []
    for i, p in enumerate(packed):
        words.append((p >> 32).to(torch.int32))
        if 2 * i + 1 < n:
            words.append((p & 0xFFFFFFFF).to(torch.int32))
    return words[:n]


def queue_pop(q: EventQueue, before: torch.Tensor, host_ids: torch.Tensor
              ) -> tuple[EventQueue, Events, torch.Tensor]:
    """Pop, per host, the minimum-key event with time < `before`: column 0
    of the sorted row, popped by a left shift of the popped rows.

    Returns (queue', events[H], active[H]); inactive rows carry
    time = TIME_INVALID.
    """
    t0 = q.time[:, 0]
    active = (t0 < before) & (t0 != TIME_INVALID)
    ev = Events(
        time=torch.where(active, t0, TIME_INVALID),
        dst=host_ids.to(torch.int32),
        src=q.src[:, 0], seq=q.seq[:, 0], kind=q.kind[:, 0],
        args=q.args[:, 0],
    )

    def shift(a, fill):
        shifted = torch.cat([a[:, 1:], torch.full_like(a[:, :1], fill)], 1)
        m = active.reshape((-1,) + (1,) * (a.dim() - 1))
        return torch.where(m, shifted, a)

    q2 = dataclasses.replace(
        q,
        time=shift(q.time, TIME_INVALID),
        src=shift(q.src, 0), seq=shift(q.seq, 0), kind=shift(q.kind, 0),
        args=shift(q.args, 0),
    )
    return q2, ev, active


def queue_push(q: EventQueue, ev: Events, mask: torch.Tensor, host0: int,
               read: Callable[[torch.Tensor], bool] = bool,
               width: int | None = None, lanes: int = 0,
               part: torch.Tensor | None = None) -> EventQueue:
    """Insert a flat batch of events [M] into their destination queues.

    Events whose dst falls outside [host0, host0 + H), that are masked
    off, or whose time is negative or TIME_INVALID are ignored. When a
    destination queue overflows, the largest-key events are dropped and
    counted in `drops`, unless the queue carries a SpillRing: then every
    evicted event lands in the ring, only ring overflow counts as drops,
    and the last round's width is not capped (full-width rounds run
    until every rank is admitted, so no event bypasses the ring). The
    algorithm is that of the reference:

    1. a flat sort groups incoming events by destination in
       (time, src, seq) order; rejected events key to H;
    2. one searchsorted over the grouped destinations gives each
       destination's run start and count;
    3. a merge round densifies an [H, W] block of each run and merges it
       into the rows with `merge.fused_merge`, then truncates to
       capacity, counting what falls off as drops;
    4. rounds are two-level: W1 = MERGE_W first and, iff some
       destination's count exceeds W1, a full-width round for the rest.

    `read` turns a 0-d bool tensor into a Python bool; it is the only
    device-to-host read here (the fallback rounds' and the hot region's
    decisions), so a caller can count them.

    A fleet's push (`lanes` > 0: the rows are L lanes of H hosts,
    lane-major) gives every lane the push of its solo run: `width` is one
    lane's batch size, from which the round widths are taken; `part`
    ([L] bool, None for all) holds the lanes that push at all; a round
    runs for the lanes whose solo push would run it, the hot-region
    choice is made per lane, and rows of the other lanes come out as
    they went in (a merge would otherwise rewrite the payload of their
    empty slots).
    """
    h, c = q.time.shape
    m = ev.time.shape[0]
    a = q.args.shape[-1]
    nw_words = 1 + a  # payload words per event: kind + args
    dev = q.time.device

    local = ev.dst - host0
    ok = (mask & (local >= 0) & (local < h)
          & (ev.time >= 0) & (ev.time != TIME_INVALID))

    # -- 1. lexicographic (dkey, time, srcseq) as three stable sorts
    dkey = torch.where(ok, local, h).to(torch.int32)
    ss = pack_srcseq(ev.src, ev.seq)
    order = torch.sort(ss, stable=True).indices
    order = order[torch.sort(ev.time[order], stable=True).indices]
    order = order[torch.sort(dkey[order], stable=True).indices]
    sdst, st, sss = dkey[order], ev.time[order], ss[order]

    # -- 2. per-destination run bounds in one searchsorted
    bounds = torch.searchsorted(
        sdst, torch.arange(h + 1, dtype=torch.int32, device=dev),
        side="left", out_int32=True,
    )
    mpos = bounds[:h]
    count = bounds[1:] - mpos

    def merge_round(q, lo, w, count_tail):
        """Admit rank in [lo, lo + w) into an [H, w] block, merge it into
        the rows, truncate to capacity. `count_tail`: the last round,
        which counts rank >= lo + w as drops."""
        cnt_r = torch.clamp(count - lo, 0, w)
        starts = mpos + lo
        lane = torch.arange(w, dtype=torch.int32, device=dev)
        gidx = starts[:, None] + lane[None, :]
        okl = lane[None, :] < cnt_r[:, None]
        oidx = order[torch.clamp(gidx, max=m - 1).long()]
        bw = [torch.where(okl, ev.kind[oidx], 0)] + [
            torch.where(okl, ev.args[:, i][oidx], 0) for i in range(a)
        ]
        bpay = torch.stack(_pack_words(bw), dim=-1)  # [H, w, NW]

        def row_merge(q, hc):
            """Merge the block into the first `hc` columns and truncate
            back to hc; columns >= hc ride along untouched."""
            qt = q.time[:, :hc].contiguous()
            qss = pack_srcseq(q.src[:, :hc], q.seq[:, :hc])
            qpay = torch.stack(_pack_words(
                [q.kind[:, :hc]] + [q.args[:, :hc, i] for i in range(a)]
            ), dim=-1)
            mt, mss, mpay = merge.fused_merge(
                qt, qss, qpay, st, sss, bpay, starts, cnt_r
            )
            over = torch.sum(mt[:, hc:] != TIME_INVALID, dim=1,
                             dtype=torch.int32)
            spill = q.spill
            if spill is None:
                if count_tail:
                    over = over + torch.clamp(count - lo - w, min=0)
                drops_add = over.to(torch.int64)
            else:
                spill, drops_add = _spill_tail(spill, c, mt[:, hc:],
                                               mss[:, hc:], mpay[:, hc:],
                                               over)
            # truncate + re-canonicalize kept empties
            keep_t = mt[:, :hc]
            emp = keep_t == TIME_INVALID
            new_src, new_seq = unpack_srcseq(
                torch.where(emp, 0, mss[:, :hc]))
            pay_k = torch.where(emp[:, :, None], 0, mpay[:, :hc, :])
            words = _unpack_words(
                [pay_k[:, :, i] for i in range(pay_k.shape[-1])], nw_words
            )
            glue = lambda head, tail: torch.cat([head, tail], dim=1)
            new_time = glue(keep_t, q.time[:, hc:])
            if spill is not None:
                fill = torch.sum(new_time != TIME_INVALID, dim=1,
                                 dtype=torch.int32)
                spill = dataclasses.replace(
                    spill, fill_hwm=torch.maximum(spill.fill_hwm, fill))
            return EventQueue(
                time=new_time,
                src=glue(new_src, q.src[:, hc:]),
                seq=glue(new_seq, q.seq[:, hc:]),
                kind=glue(words[0], q.kind[:, hc:]),
                args=torch.cat(
                    [torch.stack(words[1:], dim=-1), q.args[:, hc:]], dim=1
                ),
                drops=q.drops + drops_add,
                spill=spill,
            )

        if lanes:
            return _lane_round(q, w, row_merge, part_l, read, lanes)
        if c < 2 * HOT_C:
            return row_merge(q, c)
        # hot-region fast path: every resident event in the first HOT_C
        # columns and still fitting after admitting w more
        valid = q.time != TIME_INVALID
        n_res = torch.max(torch.sum(valid, dim=1, dtype=torch.int32))
        tail_clear = ~torch.any(valid[:, HOT_C:])
        if read(tail_clear & (n_res + w <= HOT_C)):
            return row_merge(q, HOT_C)
        return row_merge(q, c)

    w_full = min(c, m if width is None else width)
    w1 = min(w_full, MERGE_W)
    # the lanes that run the next round (a fleet's push only)
    part_l = None
    if lanes:
        part_l = (part if part is not None else torch.ones(
            (lanes,), dtype=torch.bool, device=dev))

    def more(lo):
        """Whether another round runs past rank `lo`; for lanes, also
        which lanes run it."""
        nonlocal part_l
        if not lanes:
            return read(torch.any(count > lo))
        part_l = part_l & torch.any((count > lo).reshape(lanes, -1), dim=1)
        return read(torch.any(part_l))

    if q.spill is None:
        if w1 == w_full:
            return merge_round(q, 0, w_full, True)
        q = merge_round(q, 0, w1, False)
        if more(w1):
            q = merge_round(q, w1, w_full, True)
        return q
    # spill: a rank past the last round would be dropped without ever
    # reaching the ring, so full-width rounds run until every rank is in
    # (the ring's slack equals the capacity >= w_full, so each round's
    # eviction tail fits one append)
    q = merge_round(q, 0, w1, False)
    lo = w1
    while more(lo):
        q = merge_round(q, lo, w_full, False)
        lo += w_full
    return q


def _lane_rows(flags: torch.Tensor, rows: int) -> torch.Tensor:
    """[L] lane flags broadcast to the L x H rows."""
    lanes = flags.shape[0]
    return flags[:, None].expand(lanes, rows // lanes).reshape(-1)


def _keep_tail(new: EventQueue, old: EventQueue, rows: torch.Tensor,
               c0: int) -> EventQueue:
    """`new`, except that the slots from column c0 on of the `rows` keep
    `old`'s."""
    c = new.time.shape[1]
    m = rows[:, None] & (torch.arange(c, device=rows.device) >= c0)[None, :]

    def sel(n, o):
        return torch.where(m.reshape(m.shape + (1,) * (n.dim() - 2)), o, n)

    return dataclasses.replace(new, **{
        f: sel(getattr(new, f), getattr(old, f))
        for f in ("time", "src", "seq", "kind", "args")})


def _lane_round(q: EventQueue, w: int, row_merge, part_l, read,
                lanes: int) -> EventQueue:
    """One merge round of a fleet's push: each lane takes the hot region
    or the whole row as its solo push would (one read for the fleet: the
    hot region when every lane that runs the round takes it; else the
    whole row, the lanes that would have taken the hot region keeping
    their slots past it), and the rows of lanes that do not run the
    round come out as they went in."""
    h, c = q.time.shape
    if c < 2 * HOT_C:
        out = row_merge(q, c)
    else:
        valid = q.time != TIME_INVALID
        n_res = torch.max(torch.sum(valid, dim=1, dtype=torch.int32
                                    ).reshape(lanes, -1), dim=1).values
        tail_clear = ~torch.any(valid[:, HOT_C:].reshape(lanes, -1), dim=1)
        hot = tail_clear & (n_res + w <= HOT_C)  # [L]
        if read(torch.all(hot | ~part_l)):
            out = row_merge(q, HOT_C)
        else:
            out = _keep_tail(row_merge(q, c), q, _lane_rows(hot, h), HOT_C)
    return _select_rows(_lane_rows(part_l, h), out, q)


def _spill_tail(spill: SpillRing, c: int, tail_t, tail_ss, tail_pay, over):
    """Append each row's whole [H, w] eviction tail to the ring at
    min(wr, cap) and advance `wr` by the row's valid count `over`: the
    merged row keeps empties last, so the evicted events lead the tail,
    and what follows them is overwritten by the next append or never
    read. Returns (ring', drops to add: the events past a full ring)."""
    scap = spill.time.shape[1] - c  # slack == queue capacity
    w = tail_t.shape[1]
    # the reference's per-row dynamic_update_slice would clamp a start
    # past width - w; with w <= slack it never has to
    assert w <= c, f"eviction tail {w} wider than the ring's slack {c}"
    starts = torch.clamp(spill.wr, max=scap).to(torch.int64)
    idx = starts[:, None] + torch.arange(w, dtype=torch.int64,
                                         device=starts.device)[None, :]
    wr2 = spill.wr + over
    lost = (torch.clamp(wr2 - scap, min=0)
            - torch.clamp(spill.wr - scap, min=0)).to(torch.int64)
    ring = SpillRing(
        time=spill.time.scatter(1, idx, tail_t),
        srcseq=spill.srcseq.scatter(1, idx, tail_ss),
        pay=spill.pay.scatter(
            1, idx[:, :, None].expand(tail_pay.shape), tail_pay),
        wr=wr2,
        n_spilled=spill.n_spilled + over.to(torch.int64),
        n_lost=spill.n_lost + lost,
        fill_hwm=spill.fill_hwm,
    )
    return ring, lost
