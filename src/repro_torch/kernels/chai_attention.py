"""Hand-written CUDA kernels for Clustered Head Attention, and their wrappers.

``chai_fused_decode`` launches ``csrc/chai_fused_decode.cu`` (the port of
the reference's Pallas ``chai_fused_decode``): one-pass clustered decode
over a dense cache — rep-head scores, online softmax per rep row, h2c
broadcast and per-head AV in one launch, with no (B, R, S) score tensor
in device memory. The wrapper takes CUDA tensors only; the CPU path is
the plain version in ``kernels.ref``, chosen by ``kernels.ops``.

``paged_chai_fused_decode`` launches ``csrc/paged_chai_fused_decode.cu``
(the port of the Pallas ``paged_chai_fused_decode``): the same function
over block-table page pools, the continuous engine's STEADY decode. Both
kernels run one block body (``csrc/chai_decode_tiles.cuh``): one block per
(S split, batch row, K row), the S axis streamed with fixed shared memory
(no sequence length is refused) and the splits merged in split order
inside the same launch. ``split_plan`` cuts S from (B, K rows, tiles)
alone and both wrappers call it, so at equal tile size (dense ``ts`` ==
page) their outputs are bitwise equal; ``decode_launch_config`` also
gives the block's shared memory.

Both take ``emit_state``: instead of the finalized output they return
the unnormalized online-softmax state (m (B, R), l (B, R), acc (B, H,
hd)), the suffix pass of the relay decode, which ``kernels.ops`` merges
with ``relay_prefix_decode``'s state and finalizes in torch.

Both take ``softcap`` (gemma2's tanh attention-logit cap; 0 = off): the
shared score step caps each scaled score, cap * tanh(score / cap), before
the mask, in every other mode.

Both take ``share_values`` (CHAI-QKV, MHA only): V is clustered like K
(KVv == R); each unit accumulates its rep's one row, which the finalized
mode divides and writes to every member head, and the state mode emits
as (B, R, hd). Under int8 its V codes come without scales and are read
as values (the reference's clustered V).

K and V are read each on its own, as the Pallas bodies read them: the
fused pair, the relay kernel and ``flash_attention.paged_prefix_attend``
take each side fp32, bf16 or int8, each with or without its fp32 row
scales (``_check_scales``); a side without scales is read as values, a
scale beside float rows multiplies them. ``kv_body`` decides once which
kernel body a pairing takes and the wrapper passes it to the launcher:
the serving paths' pairings (one dtype, K scaled iff int8) keep their
bodies; every other pairing runs a general body and counts its launches
by mode as "<kernel>[kv=<K>/<V>]" (``kv_modes``, from the same body).

``relay_prefix_decode`` launches ``csrc/relay_prefix_decode.cu`` (the port
of the Pallas ``relay_prefix_decode``): one pass per relay group over a
packed shared prefix, the member slots' rep queries stacked on one row
axis and routed by three int32 maps; it emits the same kind of state.
It runs two kinds of block in one launch: score blocks (a slice of the
query rows of one K row) and sum blocks (a slice of the acc rows of one
V row), so each K and V row is streamed once; ``relay_units`` is the
routing the kernel builds from the maps, ``relay_launch_config`` its
grid, split plan (``split_plan`` over the group's K rows) and shared
memory; the splits merge in order inside the launch, as in the fused
pair.

The three-kernel pipeline (the reference's retired decode, kept as the
fused kernels' baseline): ``chai_qk``, ``chai_qk_i8`` and
``paged_chai_qk`` launch ``csrc/chai_qk.cu`` (raw masked rep scores
(B, R, S) fp32, exactly NEG_INF where masked; K fp32, bf16, int8 codes
read as values, or int8 with row scales in ``chai_qk_i8``; each block a
chunk of positions of one K row for all its reps, cut by
``qk_launch_config``); ``row_softmax`` launches
``csrc/row_softmax.cu`` (each row read once into registers by a warp, a
block or a thread block cluster, cut by ``softmax_launch_config``);
``chai_av`` and ``paged_chai_av`` launch
``csrc/chai_av.cu`` (head h reads A row h2c[b, h] and its own V rows,
fp32, bf16 or int8 codes read as values, summed over every position;
each (b, h) cut into the splits of ``av_launch_config`` and merged in
order inside the launch). ``kernels.ops.chai_three_kernel_decode`` and
``paged_chai_three_kernel_decode`` drive them.

``LAUNCHES`` counts each kernel's launches, one per successful launch,
so a run can show that its main path went through the kernel;
``MODE_LAUNCHES`` counts the same launches of the fused pair, the relay,
the prefill pair and the pipeline's QK and AV pairs by the modes each
ran
(``count_launch``).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

LAUNCHES = {"chai_fused_decode": 0, "paged_chai_fused_decode": 0,
            "relay_prefix_decode": 0, "chai_qk": 0, "chai_qk_i8": 0,
            "row_softmax": 0, "chai_av": 0, "paged_chai_qk": 0,
            "paged_chai_av": 0}
# "<kernel>[<modes>]" -> launches, the modes a launch ran joined by "+" in
# the order of _MODES; a launch in no mode is counted in LAUNCHES only.
# "kv" names a K/V pairing that no serving path runs ("kv=<K>/<V>", see
# ``kv_modes``); "wide" a launch at head_dim 320 (``WIDE_HD``: the fused
# pair's and the prefill pair's wide libraries, the flash decode pair's
# kWideHd instance, the relay kernel's blocks at that head dim).
MODE_LAUNCHES: dict = {}
_MODES = ("kv", "int8", "share", "softcap", "window", "wide")

# K/V element types of the launchers' k_type / v_type (and kv_type). The
# Pallas bodies cast whatever K or V they are given to fp32 and apply each
# row scale only when it is passed, so every wrapper takes each side on
# its own: fp32, bf16 or int8, with or without its fp32 row scales (int8
# codes without scales are read as their values). ``chai_qk_i8`` takes
# int8 K with its scales.
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_KV_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int8: "i8"}
_SMEM_LIMIT = 232448        # bytes of shared memory a Hopper block may use

# chai_decode_tiles.cuh: the block body's constants
_CHUNK = 128            # kChunk: positions per chunk, the longest step
_THREADS = 128          # kThreads
_MAX_Q = 8              # kMaxQ: rep queries of one K row (reps_per_group)
_MAX_HD = 256           # kMaxHd
# kWideHd: the head_dim of the wide-head libraries (build.VARIANTS;
# gemma3-4b's 2560 / 8), which the relay kernel takes at run time too
WIDE_HD = 320
_MAX_SPLIT = 64         # kMaxSplit
_SLICE = 8              # kSlice: members (accumulator rows) of a block
_RED_VEC = 8            # kRedVec
_TAB = _CHUNK + 2       # kTab
# The split plan: aim at sixteen blocks per SM of the H100's 132 (short
# splits keep each block's chain of memory round trips short; the card
# holds that many blocks of this size at once), and cut no split shorter
# than four tiles (64 positions at the engine's page of 16).
SPLIT_TARGET_BLOCKS = 16 * 132
SPLIT_MIN_TILES = 4
# relay_prefix_decode.cu: the K or V rows of one group its in-kernel
# count holds (kMaxRows), and its fixed shared memory (kSmemBytes: the sum
# blocks' reduce, a chunk per row, m and split factors; ints)
_RELAY_MAX_ROWS = 2 * _THREADS
_RELAY_SMEM = ((_THREADS * 8 * _SLICE + _MAX_Q * _CHUNK + _MAX_Q
                + _MAX_Q * _MAX_SPLIT) * 4
               + (_RELAY_MAX_ROWS + _THREADS // 32 + 4 + 2 * _MAX_Q + 1) * 4)


def fused_tile_size(ts: int, s: int) -> int:
    """The S-tile the kernel uses: ``ts`` capped at S, and the whole
    sequence when ``ts`` does not divide it (the reference's rule)."""
    ts = min(ts, s) if ts else s
    return s if s % ts else ts


def decode_step_size(ts: int) -> int:
    """The decode kernels' online-softmax step for a tile of ``ts``
    positions: ``ts`` itself up to 128 (every tile the engine and the
    reference's sweeps use), else its largest divisor <= 128, so a step
    never straddles a tile (or a page) and the block's shared memory stays
    fixed whatever the tile."""
    return max(d for d in range(1, min(ts, _CHUNK) + 1) if ts % d == 0)


class DecodeLaunch(NamedTuple):
    """How a fused decode call is cut: ``n_split`` ranges of
    ``tiles_per_split`` whole tiles (the last may be shorter), ``n_cap``
    member heads (accumulator rows) per block, and the block's dynamic
    shared memory in bytes (``block_smem_bytes`` of
    ``csrc/chai_decode_tiles.cuh``)."""
    n_split: int
    tiles_per_split: int
    n_cap: int
    smem_bytes: int


def split_plan(b: int, k_rows: int, n_tiles: int):
    """(n_split, tiles_per_split) of a call with ``b`` batch rows,
    ``k_rows`` K rows per batch row (the work units are b * k_rows) and
    ``n_tiles`` tiles per row: enough splits that units x splits reaches
    ``SPLIT_TARGET_BLOCKS``, at most ``_MAX_SPLIT``, none shorter than
    ``SPLIT_MIN_TILES`` tiles. It reads no layout and no ``pos``, so the
    dense and the paged call at equal shapes cut alike."""
    want = min(_MAX_SPLIT, max(1, -(-SPLIT_TARGET_BLOCKS // (b * k_rows))))
    per = max(-(-n_tiles // want), SPLIT_MIN_TILES)
    return -(-n_tiles // per), per


def split_ranges(b: int, k_rows: int, n_tiles: int):
    """The tile ranges [t0, t1) of the splits, in order (the kernel's
    s * tps .. min(n_tiles, (s + 1) * tps))."""
    n_split, per = split_plan(b, k_rows, n_tiles)
    return [(s * per, min(n_tiles, (s + 1) * per)) for s in range(n_split)]


def _query_bucket(nq: int, general: bool = False) -> int:
    """The block's query count kQ for ``nq`` queries: 1, 2, 4 or 8; the
    general body's always 8 (its loops skip the queries past ``nq``)."""
    return _MAX_Q if general else next(k for k in (1, 2, 4, _MAX_Q)
                                       if nq <= k)


# The kernel body a K/V pairing takes (``kv_body``), passed to the
# launchers of the fused pair, the relay kernel and the prefix pass.
KV_FLOAT, KV_INT8, KV_GENERAL = 0, 1, 2


def kv_body(k, k_scale, v, v_scale, *, int8_raw_v=True) -> int:
    """The kernel body a call's K/V pairing takes, decided here once:
    ``KV_FLOAT`` for K and V of one float dtype without scales,
    ``KV_INT8`` for int8 K and V with K's scales and V's (or, where
    ``int8_raw_v``, without: the int8 bodies of the fused pair and the
    relay read raw V codes, the prefix pass's needs both scales). These
    are the serving paths' pairings, whose bodies fix each scale step by
    the type. Every other pairing takes ``KV_GENERAL``, whose body tests
    each scale at run time."""
    if k.dtype == v.dtype != torch.int8 and k_scale is None is v_scale:
        return KV_FLOAT
    if (k.dtype == v.dtype == torch.int8 and k_scale is not None
            and (v_scale is not None or int8_raw_v)):
        return KV_INT8
    return KV_GENERAL


def block_smem_bytes(kq: int, hd: int, n_map: int, n_cap: int) -> int:
    """``block_smem_bytes`` of ``csrc/chai_decode_tiles.cuh``: the block's
    queries, a chunk of scores and of step factors per query, the AV
    partials, n_cap accumulator rows, the merge factors and m/l/A (fp32),
    then the member list (3 ints per map entry), the chunk's block-table
    entries and two flags. No term depends on the sequence length."""
    floats = (kq * hd + 2 * kq * _CHUNK + _THREADS * _RED_VEC + n_cap * hd
              + kq * _MAX_SPLIT + 3 * kq)
    ints = 3 * n_map + 2 * _TAB + 2
    return (floats + ints) * 4


def decode_launch_config(b: int, k_rows: int, n_tiles: int, hd: int,
                         n_map: int, reps_per_group: int = 1,
                         share_values: bool = False,
                         general: bool = False) -> DecodeLaunch:
    """The launch of one fused decode call: the split plan from (b,
    k_rows, n_tiles), and the block's shared memory for ``reps_per_group``
    queries per block and an ``n_map``-entry member map (H heads).
    ``share_values``: one accumulator row a unit (its rep's); ``general``:
    the general body's query bucket (``kv_body``)."""
    n_split, per = split_plan(b, k_rows, n_tiles)
    n_cap = 1 if share_values else max(1, min(n_map, _SLICE))
    return DecodeLaunch(n_split, per, n_cap, block_smem_bytes(
        _query_bucket(reps_per_group, general), hd, n_map, n_cap))


class RelayLaunch(NamedTuple):
    """How a ``relay_prefix_decode`` call is cut: ``q_slots`` score blocks
    and ``v_slots`` sum blocks per (group, split), upper bounds on the
    group's query slices and acc slices; ``n_split`` ranges of
    ``tiles_per_split`` whole tiles; the block's dynamic shared memory in
    bytes (``kSmemBytes`` of ``csrc/relay_prefix_decode.cu``)."""
    q_slots: int
    v_slots: int
    n_split: int
    tiles_per_split: int
    smem_bytes: int


def relay_slots(n: int, rows: int) -> int:
    """An upper bound on the slices of a map of ``n`` entries over
    ``rows`` rows, each row's entries cut into ceil(c / 8) slices: at most
    n // 8 + (the rows named), and never more than n; at least 1."""
    return max(1, min(n, n // _MAX_Q + min(rows, n)))


def relay_launch_config(g: int, nr: int, a_total: int, kv: int, vr: int,
                        n_tiles: int) -> RelayLaunch:
    """The launch of one relay call on G groups of ``nr`` query rows over
    ``kv`` K rows and ``a_total`` acc rows over ``vr`` V rows, ``n_tiles``
    tiles each: the fused pair's split plan over the (group, K row)
    units, and shared memory fixed whatever Sp, NR and A."""
    n_split, per = split_plan(g, kv, n_tiles)
    return RelayLaunch(relay_slots(nr, kv), relay_slots(a_total, vr),
                       n_split, per, _RELAY_SMEM)


def relay_counters(g: int, cfg: RelayLaunch) -> int:
    """int32 counters of one relay launch: the dispatch counter, two per
    (group, split) and a merge ticket per score and per sum slot."""
    return 1 + 2 * g * cfg.n_split + g * (cfg.q_slots + cfg.v_slots)


def _slices(row_of, cap):
    """A map's entries (row_of[e]) as the kernel slices them: row by row,
    each row's entries in map order cut into ceil(c / cap) slices of
    near-equal size, slice z holding ranks [z * c // n, (z + 1) * c // n)
    of n slices. Returns [(row, [entries])]."""
    out = []
    for row in sorted(set(row_of)):
        ents = [e for e, x in enumerate(row_of) if x == row]
        n = -(-len(ents) // cap)
        out += [(row, ents[z * len(ents) // n:(z + 1) * len(ents) // n])
                for z in range(n)]
    return out


def relay_units(k_row, a_row, v_row):
    """The routing ``relay_prefix_decode``'s blocks build from the maps,
    as plain Python (the kernel's mirror; also the tests' and
    ``chip_smoke.py``'s count of the rows streamed). Per group, in slot
    order: ``scores``, dicts of ``kv`` and ``queries`` (the query rows a
    score block dots with K row kv, at most 8), and ``sums``, dicts of
    ``vr`` and ``members`` (at most 8 (acc row, query row) pairs a sum
    block weights V row vr for). Returns [{scores, sums} of group 0,
    ...]."""
    k_row, a_row, v_row = ([list(map(int, r)) for r in x.tolist()]
                           for x in (k_row, a_row, v_row))
    return [dict(scores=[dict(kv=kv, queries=qs)
                         for kv, qs in _slices(kr, _MAX_Q)],
                 sums=[dict(vr=vr, members=[(e, ar[e]) for e in ents])
                       for vr, ents in _slices(vrow, _SLICE)])
            for kr, ar, vrow in zip(k_row, a_row, v_row)]


def dense_launch_config(q_rep, k_cache, h2c, *, reps_per_group=1, ts=512,
                        share_values=False, general=False):
    """(the launch, the S-tile) of ``chai_fused_decode`` on these tensors
    (their shapes only: any device, ``meta`` too)."""
    s = k_cache.shape[2]
    ts = fused_tile_size(ts, s)
    return decode_launch_config(q_rep.shape[0], k_cache.shape[1], s // ts,
                                q_rep.shape[2], h2c.shape[-1],
                                reps_per_group, share_values, general), ts


def paged_launch_config(q_rep, k_pool, bt_k, h2c, *, reps_per_group=1,
                        share_values=False, general=False):
    """The launch of ``paged_chai_fused_decode`` on these tensors (their
    shapes only); the tile is the page. Equal to the dense call's at
    S == P * page and ts == page."""
    return decode_launch_config(q_rep.shape[0], k_pool.shape[1],
                                bt_k.shape[1], q_rep.shape[2],
                                h2c.shape[-1], reps_per_group, share_values,
                                general)


def _launcher(name, n_ptrs, n_ints, n_floats=0, lib=None):
    """A launcher's ctypes function: ``n_ptrs`` pointers, ``n_ints`` ints,
    ``n_floats`` floats, then the stream; from library ``lib`` (a variant
    of ``name``'s source, ``build.VARIANTS``) when given."""
    from repro_torch.kernels import build
    fn = getattr(build.load(lib or name), f"{name}_launch")
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                   + [ctypes.c_float] * n_floats + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _wide_lib(name, wide, body):
    """The variant library a fused decode launch takes (``build.
    VARIANTS``): none below head_dim 320; at 320 the serving pairings'
    (``<name>_wide``) or the general body's (``<name>_wide_kv``)."""
    if not wide:
        return None
    return f"{name}_wide_kv" if body == KV_GENERAL else f"{name}_wide"


def _check_scales(name, k, v, k_scale, v_scale):
    """Each side on its own, as the Pallas bodies read it: K and V are
    each fp32, bf16 or int8, and each scale is optional; a scale, where
    given, is fp32 of its side's shape without the last axis (one scale a
    row) on its side's device. A missing scale reads the side as values
    (int8 codes too); a scale beside float rows multiplies them. Shapes
    only, so it runs on any device."""
    for side, x, sc in (("K", k, k_scale), ("V", v, v_scale)):
        if x.dtype not in _KV_DTYPES:
            raise TypeError(f"{name}: {side} must be fp32, bf16 or int8; got "
                            f"{x.dtype}")
        if sc is not None and (sc.shape != x.shape[:-1]
                               or sc.dtype != torch.float32
                               or sc.device != x.device):
            raise ValueError(f"{name}: {side}'s scale must be fp32 of its "
                             f"shape without the last axis on its device; "
                             f"got {tuple(sc.shape)} {sc.dtype} on "
                             f"{sc.device} for {side} {tuple(x.shape)} on "
                             f"{x.device}")


def kv_modes(body, k, k_scale, v, v_scale):
    """The modes a launch on ``body`` (``kv_body``) counts for its K/V
    pairing: none on ``KV_FLOAT``; ``int8`` on ``KV_INT8``; on
    ``KV_GENERAL`` ``kv`` = "<K>/<V>", each side its dtype (f32, bf16,
    i8) with "s" when scaled (a pairing no serving path runs)."""
    if body != KV_GENERAL:
        return dict(int8=body == KV_INT8)
    return dict(kv="/".join(_KV_NAMES[x.dtype] + ("s" if sc is not None
                                                  else "")
                            for x, sc in ((k, k_scale), (v, v_scale))))


def _check_block(name, hd, reps_per_group, cfg):
    """The block body's limits: 16-byte row loads, at most ``_MAX_Q``
    queries a block, and a block's shared memory (fixed in S; it grows
    with the member map only). The head dim: a multiple of 8 up to
    ``_MAX_HD``, or ``WIDE_HD`` (the fused pair on its wide-head
    libraries, every K/V pairing; the relay kernel, whose blocks take the
    head dim at run time)."""
    if hd % 8 or not (0 < hd <= _MAX_HD or hd == WIDE_HD):
        raise ValueError(f"{name}: head_dim {hd} must be a multiple of 8 "
                         f"and at most {_MAX_HD} (16-byte row loads), or "
                         f"{WIDE_HD}")
    if not 0 < reps_per_group <= _MAX_Q:
        raise ValueError(f"{name}: reps_per_group {reps_per_group} must be "
                         f"1..{_MAX_Q}")
    if cfg.smem_bytes > _SMEM_LIMIT:
        raise ValueError(f"{name}: the member map needs {cfg.smem_bytes} B "
                         "of shared memory, above the block limit")


def _check_share(name, q_rep, v, reps_per_group):
    """The share mode: MHA only (the reference asserts it) and V clustered
    like K (KVv == R). Shapes only, so it runs on any device."""
    if reps_per_group > 1:
        raise ValueError(f"{name}: share_values (clustered V) is an MHA-only "
                         f"ablation; got reps_per_group={reps_per_group}")
    if v.shape[1] != q_rep.shape[1]:
        raise ValueError(f"{name}: share_values reads one V row per rep; got "
                         f"KVv={v.shape[1]} for R={q_rep.shape[1]}")


def _check_common(name, q_rep, k, v, h2c, reps_per_group, share_values):
    """Device, dtype and width checks both wrappers share; returns
    (b, R, hd, H, h2c as (B, H))."""
    if q_rep.device.type != "cuda":
        raise ValueError(f"{name} launches a CUDA kernel; got tensors on "
                         f"{q_rep.device}")
    b, r_total, hd = q_rep.shape
    if h2c.ndim == 1:
        h2c = h2c.expand(b, h2c.shape[0])
    h_total = h2c.shape[1]
    if k.shape[1] * reps_per_group != r_total or (
            not share_values and h_total % v.shape[1]):
        raise ValueError(f"R={r_total} must be KVk={k.shape[1]} x "
                         f"reps_per_group={reps_per_group} and KVv="
                         f"{v.shape[1]} must divide H={h_total}")
    return b, r_total, hd, h_total, h2c


def _check_aligned(name, **tensors):
    """The kernels load rows 16 bytes at a time."""
    for key, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be 16-byte aligned")


def _small(t, dev):
    """int32 contiguous copy of a small index tensor (h2c, pos, tables)."""
    return t.to(device=dev, dtype=torch.int32).contiguous()


def _outputs(b, r_total, h_total, hd, dev, emit_state, acc_rows):
    """The decode kernels' outputs: (B, H, hd) fp32, and with
    ``emit_state`` the (B, R) m and l as well (else None) and acc as
    (B, acc_rows, hd) (the heads, or the reps under share_values)."""
    out = torch.empty((b, acc_rows if emit_state else h_total, hd),
                      dtype=torch.float32, device=dev)
    if not emit_state:
        return out, None, None
    return (out,) + tuple(torch.empty((b, r_total), dtype=torch.float32,
                                      device=dev) for _ in range(2))


# Ticket counters of the in-launch split merge, one int32 per work unit,
# kept per (device, stream): zero between launches (each unit's merging
# block resets its own), so a launch needs no fill of its own.
_COUNTERS: dict = {}


def _unit_counter(units, dev, stream):
    """The (device, stream)'s ticket counters, at least ``units`` of
    them (a larger set is allocated, zeroed, when the kept one is
    short)."""
    key = (dev.index, stream)
    counter = _COUNTERS.get(key)
    if counter is None or counter.numel() < units:
        counter = torch.zeros(units, dtype=torch.int32, device=dev)
        _COUNTERS[key] = counter
    return counter


def split_scratch(n_split, b, r_total, h_total, hd, units, dev, stream, *,
                  one_split=False):
    """(mp, lp, accp, counter) of a split launch: the partial m and l
    (B, n_split, R) and the raw partial acc (B, n_split, H, hd) (H: the
    acc rows; the reps under share_values), fp32, in
    one ``torch.empty`` (the kernel reads no slot it has not written),
    and the unit counters; all None when the call is not split, unless
    ``one_split`` (the relay kernel merges one split like many). The flash
    decode pair (``kernels.flash_attention``) takes its scratch here too,
    with R == H; the counters are shared (launches on one stream run in
    order, and each leaves them at zero)."""
    if n_split == 1 and not one_split:
        return None, None, None, None
    counter = _unit_counter(units, dev, stream)
    ns = n_split
    buf = torch.empty(b * ns * (h_total * hd + 2 * r_total),
                      dtype=torch.float32, device=dev)
    # acc first: the merge reads it 16 bytes at a time (hd % 8 == 0)
    acc, m, l = buf.split([b * ns * h_total * hd, b * ns * r_total,
                           b * ns * r_total])
    return m, l, acc, counter


def count_launch(counts, name, **modes):
    """One successful launch of ``name``: one in ``counts`` (its module's
    LAUNCHES) and one in MODE_LAUNCHES under the ``modes`` that are set
    ("kv=<pairing>" for the ``kv`` mode)."""
    counts[name] += 1
    tag = "+".join(f"kv={modes[m]}" if m == "kv" else m for m in _MODES
                   if modes.get(m))
    if tag:
        key = f"{name}[{tag}]"
        MODE_LAUNCHES[key] = MODE_LAUNCHES.get(key, 0) + 1


def _ptr(t):
    """A tensor's address, or a null pointer for None."""
    return None if t is None else t.data_ptr()


def chai_fused_decode(q_rep, k_cache, v_cache, h2c, pos, *, k_scale=None,
                      v_scale=None, reps_per_group=1, share_values=False,
                      window=0, ts=512, softcap=0.0, emit_state=False):
    """One-pass fused clustered decode over a dense cache, on the GPU.

    q_rep: (B, R, hd) rep-head queries (any float dtype; read as fp32);
    k_cache: (B, KVk, S, hd) with KVk * reps_per_group == R (MHA
    clustered cache: KVk == R); v_cache: (B, KVv, S, hd), per-head
    (KVv == H) or per-group (H % KVv == 0); K/V fp32 or bf16, one dtype;
    h2c: (B, H) or (H,) head -> rep row, values in [0, R); pos: (B,).
    K and V each fp32, bf16 or int8, each with or without its fp32 row
    scales k_scale (B, KVk, S) / v_scale (B, KVv, S), as the Pallas
    wrapper takes them: the K scale multiplies the score after the dot,
    the V scale the V row before A.V (the Pallas tile's order); a side
    without scales is read as values (int8 codes too). The int8 KV cache
    passes int8 K and V with both scales. Any S: the kernel streams it with fixed shared memory, cut
    into ``split_plan`` ranges merged inside the launch. Returns (B, H,
    hd) fp32 from ONE kernel launch, or with ``emit_state`` the
    unnormalized (m (B, R), l (B, R), acc (B, H, hd)) fp32 state.
    ``share_values`` (MHA, reps_per_group 1): v_cache (B, R, S, hd) is the
    clustered V, rep j reading V row j (under int8, codes without
    v_scale); the state's acc is (B, R, hd).
    ``softcap`` (gemma2's ``attn_logit_softcap``; 0 = off): every score,
    once scaled, becomes softcap * tanh(score / softcap) before the mask,
    in any of the modes above.
    head_dim: a multiple of 8 up to 256, or ``WIDE_HD`` (320, gemma3-4b)
    on the wide-head libraries (``build.VARIANTS``: the serving pairings'
    and the general pairings'), counted in the ``wide`` mode.
    """
    _check_scales("chai_fused_decode", k_cache, v_cache, k_scale, v_scale)
    if share_values:
        _check_share("chai_fused_decode", q_rep, v_cache, reps_per_group)
    s = k_cache.shape[2]
    b, r_total, hd, h_total, h2c = _check_common(
        "chai_fused_decode", q_rep, k_cache, v_cache, h2c, reps_per_group,
        share_values)
    kv_k, kv_v = k_cache.shape[1], v_cache.shape[1]
    if (k_cache.shape[0] != b or k_cache.shape[3] != hd
            or v_cache.shape != (b, kv_v, s, hd)):
        raise ValueError(f"shape mismatch: q {tuple(q_rep.shape)}, "
                         f"k {tuple(k_cache.shape)}, v {tuple(v_cache.shape)}")
    body = kv_body(k_cache, k_scale, v_cache, v_scale)
    cfg, ts = dense_launch_config(
        q_rep, k_cache, h2c, reps_per_group=reps_per_group, ts=ts,
        share_values=share_values, general=body == KV_GENERAL)
    _check_block("chai_fused_decode", hd, reps_per_group, cfg)
    wide = hd == WIDE_HD
    dev = q_rep.device
    q = q_rep.float().contiguous()
    k = k_cache.contiguous()
    v = v_cache.contiguous()
    _check_aligned("chai_fused_decode", k_cache=k, v_cache=v)
    ks, vs = (None if t is None else t.contiguous()
              for t in (k_scale, v_scale))
    h2c_i, pos_i = _small(h2c, dev), _small(pos, dev)
    rows = r_total if share_values else h_total
    out, m, l = _outputs(b, r_total, h_total, hd, dev, emit_state, rows)
    fn = _launcher("chai_fused_decode", 14, 19, 1,
                   lib=_wide_lib("chai_fused_decode", wide, body))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        scratch = split_scratch(cfg.n_split, b, r_total, rows, hd,
                                b * kv_k, dev, stream)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(ks),
                 _ptr(vs), h2c_i.data_ptr(),
                 pos_i.data_ptr(), out.data_ptr(), _ptr(m), _ptr(l),
                 *(_ptr(t) for t in scratch), b, r_total, h_total, kv_k,
                 kv_v, s, hd, ts, decode_step_size(ts), reps_per_group,
                 1 if share_values else h_total // kv_v, int(window),
                 cfg.n_split, cfg.tiles_per_split, cfg.n_cap,
                 int(share_values), _KV_DTYPES[k.dtype], _KV_DTYPES[v.dtype],
                 body, float(softcap), stream)
    if err:
        raise RuntimeError(f"chai_fused_decode launch failed: CUDA error "
                           f"{err}")
    count_launch(LAUNCHES, "chai_fused_decode",
                 **kv_modes(body, k, ks, v, vs),
                 share=share_values, softcap=softcap, window=int(window) > 0,
                 wide=wide)
    return (m, l, out) if emit_state else out


def paged_chai_fused_decode(q_rep, k_pool, bt_k, v_pool, bt_v, h2c, pos, *,
                            k_scale_pool=None, v_scale_pool=None,
                            reps_per_group=1, share_values=False, window=0,
                            softcap=0.0, emit_state=False):
    """One-pass fused clustered decode over block-table page pools, on
    the GPU.

    q_rep: (B, R, hd) (any float dtype; read as fp32); k_pool:
    (nPk, KVk, page, hd), the clustered pool of one layer (MHA: KVk ==
    k_max); v_pool: (nPv, KVv, page, hd), the dense per-head pool;
    bt_k/bt_v: (B, P) block tables into their own pools (tile t of row b
    is page bt[b, t]; the tile size is the page); h2c: (B, H) or (H,);
    pos: (B,). K and V each fp32, bf16 or int8, each with or without its
    scale pool k_scale_pool (nPk, KVk, page) / v_scale_pool (nPv, KVv,
    page), read through the same tables (the dense call's pairings). Any
    P: the
    split plan is the dense call's at equal shapes, so at page == ts the
    two are bitwise equal. The pools are layer slices of the engine's
    state and are read in place: they must be contiguous already (a copy
    would move the whole pool every call). Returns (B, H, hd) fp32 from
    ONE kernel launch, or the ``emit_state`` triple. ``share_values``:
    v_pool is the clustered pool (KVv == R; the engine's ``cp`` through
    ``bt_vc``), as in the dense call; ``softcap`` and head_dim 320 (the
    wide-head libraries) as in the dense call.
    """
    _check_scales("paged_chai_fused_decode", k_pool, v_pool, k_scale_pool,
                  v_scale_pool)
    if share_values:
        _check_share("paged_chai_fused_decode", q_rep, v_pool,
                     reps_per_group)
    n_pages = bt_k.shape[1]
    page = k_pool.shape[2]
    b, r_total, hd, h_total, h2c = _check_common(
        "paged_chai_fused_decode", q_rep, k_pool, v_pool, h2c,
        reps_per_group, share_values)
    kv_k, kv_v = k_pool.shape[1], v_pool.shape[1]
    if (k_pool.shape[3] != hd or v_pool.shape[2:] != (page, hd)
            or bt_k.shape != (b, n_pages) or bt_v.shape != (b, n_pages)):
        raise ValueError(f"shape mismatch: q {tuple(q_rep.shape)}, k_pool "
                         f"{tuple(k_pool.shape)}, v_pool "
                         f"{tuple(v_pool.shape)}, bt_k {tuple(bt_k.shape)}, "
                         f"bt_v {tuple(bt_v.shape)}")
    body = kv_body(k_pool, k_scale_pool, v_pool, v_scale_pool)
    cfg = paged_launch_config(
        q_rep, k_pool, bt_k, h2c, reps_per_group=reps_per_group,
        share_values=share_values, general=body == KV_GENERAL)
    _check_block("paged_chai_fused_decode", hd, reps_per_group, cfg)
    wide = hd == WIDE_HD
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("k_scale_pool", k_scale_pool),
                    ("v_scale_pool", v_scale_pool)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (pools are read "
                             "in place, never copied)")
    _check_aligned("paged_chai_fused_decode", k_pool=k_pool, v_pool=v_pool)
    dev = q_rep.device
    q = q_rep.float().contiguous()
    bt_k_i, bt_v_i = _small(bt_k, dev), _small(bt_v, dev)
    h2c_i, pos_i = _small(h2c, dev), _small(pos, dev)
    rows = r_total if share_values else h_total
    out, m, l = _outputs(b, r_total, h_total, hd, dev, emit_state, rows)
    fn = _launcher("paged_chai_fused_decode", 16, 19, 1,
                   lib=_wide_lib("paged_chai_fused_decode", wide, body))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        scratch = split_scratch(cfg.n_split, b, r_total, rows, hd,
                                b * kv_k, dev, stream)
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 _ptr(k_scale_pool), _ptr(v_scale_pool),
                 bt_k_i.data_ptr(), bt_v_i.data_ptr(), h2c_i.data_ptr(),
                 pos_i.data_ptr(), out.data_ptr(), _ptr(m), _ptr(l),
                 *(_ptr(t) for t in scratch), b, r_total, h_total, kv_k,
                 kv_v, n_pages, page, hd, decode_step_size(page),
                 reps_per_group, 1 if share_values else h_total // kv_v,
                 int(window), cfg.n_split, cfg.tiles_per_split, cfg.n_cap,
                 int(share_values), _KV_DTYPES[k_pool.dtype],
                 _KV_DTYPES[v_pool.dtype], body, float(softcap), stream)
    if err:
        raise RuntimeError(f"paged_chai_fused_decode launch failed: CUDA "
                           f"error {err}")
    count_launch(LAUNCHES, "paged_chai_fused_decode",
                 **kv_modes(body, k_pool, k_scale_pool, v_pool,
                            v_scale_pool),
                 share=share_values, softcap=softcap, window=int(window) > 0,
                 wide=wide)
    return (m, l, out) if emit_state else out


def relay_prefix_decode(q, k, v, k_row, a_row, v_row, plen, *, k_scale=None,
                        v_scale=None, ts=0, softcap=0.0):
    """One pass per relay group over its packed shared prefix, on the GPU.

    q: (G, NR, hd) member rep queries stacked per group (any float dtype;
    read as fp32); k: (G, KV, Sp, hd) and v: (G, VR, Sp, hd) the packed
    prefix, each fp32, bf16 or int8, each with or without its scale plane
    k_scale (G, KV, Sp) / v_scale (G, VR, Sp) (the score blocks scale each
    score after the dot, the sum blocks each V row before the weighted
    sum; a side without scales is read as values, as the share_values
    relay's int8 V is); k_row: (G, NR) query row -> K row;
    a_row: (G, A) acc row -> query row; v_row: (G, A) acc row -> V row;
    plen: (G,) valid prefix lengths (positions >= plen masked).
    ``softcap`` != 0: each scaled score (int8: after the K scale) becomes
    softcap * tanh(score / softcap). ``ts``:
    the S-tile (0: Sp; the whole prefix when it does not divide Sp). Any
    Sp, NR and A: the kernel streams Sp with shared memory fixed in all
    three, cut into ``split_plan`` ranges merged inside the launch; at
    most 256 K rows and 256 V rows. head_dim: a multiple of 8 up to 256,
    or ``WIDE_HD`` (320), counted in the ``wide`` mode. Scratch: the
    scores (G, NR, Sp) fp32 and the splits' partial states.
    Returns (m (G, NR), l (G, NR), acc (G, A, hd)) fp32, unnormalized, from
    ONE kernel launch.
    """
    _check_scales("relay_prefix_decode", k, v, k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"relay_prefix_decode launches a CUDA kernel; got "
                         f"tensors on {q.device}")
    g, nr, hd = q.shape
    kv, sp = k.shape[1], k.shape[2]
    vr, a_total = v.shape[1], a_row.shape[1]
    if (k.shape != (g, kv, sp, hd) or v.shape != (g, vr, sp, hd)
            or k_row.shape != (g, nr) or a_row.shape != (g, a_total)
            or v_row.shape != (g, a_total) or plen.shape != (g,)):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, k_row "
                         f"{tuple(k_row.shape)}, a_row {tuple(a_row.shape)},"
                         f" v_row {tuple(v_row.shape)}, plen "
                         f"{tuple(plen.shape)}")
    if not (0 < kv <= _RELAY_MAX_ROWS and 0 < vr <= _RELAY_MAX_ROWS
            and nr):
        raise ValueError(f"relay_prefix_decode: {kv} K rows, {vr} V rows "
                         f"and {nr} query rows; the kernel counts 1.."
                         f"{_RELAY_MAX_ROWS} rows of each and needs a query "
                         "row")
    ts = fused_tile_size(ts, sp)
    cfg = relay_launch_config(g, nr, a_total, kv, vr, sp // ts)
    _check_block("relay_prefix_decode", hd, 1, cfg)
    wide = hd == WIDE_HD
    dev = q.device
    qf = q.float().contiguous()
    kc, vc = k.contiguous(), v.contiguous()
    _check_aligned("relay_prefix_decode", k=kc, v=vc)
    ks, vs = (None if t is None else t.contiguous()
              for t in (k_scale, v_scale))
    body = kv_body(kc, ks, vc, vs)
    maps = [_small(t, dev) for t in (k_row, a_row, v_row, plen)]
    m = torch.empty((g, nr), dtype=torch.float32, device=dev)
    l = torch.empty((g, nr), dtype=torch.float32, device=dev)
    acc = torch.empty((g, a_total, hd), dtype=torch.float32, device=dev)
    scores = torch.empty((g, nr, sp), dtype=torch.float32, device=dev)
    fn = _launcher("relay_prefix_decode", 17, 15, 1)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        mp, lp, accp, counter = split_scratch(
            cfg.n_split, g, nr, a_total, hd, relay_counters(g, cfg), dev,
            stream, one_split=True)
        err = fn(qf.data_ptr(), kc.data_ptr(), vc.data_ptr(), _ptr(ks),
                 _ptr(vs),
                 *(t.data_ptr() for t in maps), m.data_ptr(), l.data_ptr(),
                 acc.data_ptr(), mp.data_ptr(), lp.data_ptr(),
                 accp.data_ptr(), scores.data_ptr(), counter.data_ptr(), g,
                 nr, a_total, kv, vr, sp, hd, ts, cfg.n_split,
                 cfg.tiles_per_split, cfg.q_slots, cfg.v_slots,
                 _KV_DTYPES[kc.dtype], _KV_DTYPES[vc.dtype], body,
                 float(softcap), stream)
    if err:
        raise RuntimeError(f"relay_prefix_decode launch failed: CUDA error "
                           f"{err}")
    count_launch(LAUNCHES, "relay_prefix_decode",
                 **kv_modes(body, kc, ks, vc, vs), softcap=softcap,
                 wide=wide)
    return m, l, acc


# ---------------------------------------------------------------------------
# The three-kernel pipeline: QK -> row softmax -> AV
# ---------------------------------------------------------------------------

def _tile_check(name, ts, s):
    """The Pallas wrappers' tile assertion: ``ts`` (capped at S) must
    divide S. The CUDA kernels do not tile by it."""
    ts = min(ts, s)
    if ts <= 0 or s % ts:
        raise ValueError(f"{name}: S={s} is not a multiple of ts={ts}")


class QkLaunch(NamedTuple):
    """How a QK call (``chai_qk``, ``chai_qk_i8``, ``paged_chai_qk``) is
    cut: a block takes ``positions`` consecutive positions of one K row of
    one batch row, for ``reps`` of the K row's reps (all of them in
    ``slices`` blocks); ``lanes`` threads read a row, with loads of
    ``vec`` elements, and each thread loads ``rows`` positions before it
    adds, ``rounds`` times (positions = 128 / lanes * rows * rounds);
    ``n_chunks`` chunks of ``positions`` cover S."""
    positions: int
    rows: int
    rounds: int
    lanes: int
    reps: int
    vec: int
    slices: int
    n_chunks: int


# chai_qk.cu: kRows (positions a thread loads before it adds) and
# kMaxReps (reps a block serves). The plan halves the rows a thread takes
# while the grid holds fewer than QK_FILL_BLOCKS blocks (four a SM of the
# H100's 132), then gives a block more rounds while the grid keeps at
# least QK_TARGET_BLOCKS, up to QK_MAX_POSITIONS positions a block.
QK_ROWS = 4
QK_MAX_REPS = 8
QK_MAX_POSITIONS = 512
QK_FILL_BLOCKS = 4 * 132
QK_TARGET_BLOCKS = 8 * 132


def load_width(hd: int, elem_bytes: int) -> int:
    """Elements of one row load: the widest load of 16, 8, 4 or 2 bytes
    whose element count divides hd (at least two elements: hd is even)."""
    vec = 16 // elem_bytes
    while vec > 2 and hd % vec:
        vec //= 2
    return vec


def qk_launch_config(b: int, r: int, kv: int, s: int, hd: int,
                     elem_bytes: int) -> QkLaunch:
    """The launch of one QK call on ``b`` batch rows of ``r`` reps over
    ``kv`` K rows (r // kv reps a row), S = ``s`` positions and rows of
    ``hd`` elements of ``elem_bytes``: the lanes of a row are the power
    of two at or above its loads, at most 32 (a wider row takes further
    passes); the reps of a K row are cut into the fewest slices of at
    most ``QK_MAX_REPS``. It reads no layout and no ``pos``, so the dense
    and the paged call at equal shapes cut alike."""
    vec = load_width(hd, elem_bytes)
    lanes = min(32, 1 << (hd // vec - 1).bit_length())
    rpg = r // kv
    slices = -(-rpg // QK_MAX_REPS)
    units = b * kv * slices
    groups = _THREADS // lanes
    rows = min(QK_ROWS, QK_MAX_POSITIONS // groups)
    while rows > 1 and units * -(-s // (groups * rows)) < QK_FILL_BLOCKS:
        rows //= 2
    per_round = groups * rows
    rounds = max(1, min(QK_MAX_POSITIONS // per_round,
                        units * -(-s // per_round) // QK_TARGET_BLOCKS))
    positions = per_round * rounds
    return QkLaunch(positions, rows, rounds, lanes,
                    -(-rpg // slices), vec, slices, -(-s // positions))


def _qk_inputs(name, q_rep, k, pos, reps_per_group, dtypes, s):
    """Checks shared by the QK wrappers; returns (b, R, hd, q fp32, pos
    int32, the (B, R, S) fp32 output, the launch's plan)."""
    if q_rep.device.type != "cuda" or k.device != q_rep.device:
        raise ValueError(f"{name} launches a CUDA kernel; got q on "
                         f"{q_rep.device} and K on {k.device}")
    if k.dtype not in dtypes:
        raise TypeError(f"{name}: K must be {dtypes}; got {k.dtype}")
    b, r_total, hd = q_rep.shape
    if k.shape[1] * reps_per_group != r_total or k.shape[3] != hd:
        raise ValueError(f"{name}: q {tuple(q_rep.shape)} against K "
                         f"{tuple(k.shape)} with reps_per_group="
                         f"{reps_per_group}")
    if hd % 2:
        raise ValueError(f"{name}: head_dim {hd} must be even (loads of at "
                         "least two elements)")
    dev = q_rep.device
    cfg = qk_launch_config(b, r_total, k.shape[1], s, hd, k.element_size())
    return (b, r_total, hd, q_rep.float().contiguous(), _small(pos, dev),
            torch.empty((b, r_total, s), dtype=torch.float32, device=dev),
            cfg)


def _qk_plan_args(cfg: QkLaunch):
    """The launchers' plan arguments, in their order."""
    return (cfg.vec, cfg.lanes, cfg.rows, cfg.positions, cfg.reps,
            cfg.slices)


def _aligned(t, vec):
    """``t`` itself when its address suits loads of ``vec`` elements, else
    a copy (a fresh allocation is aligned): a contiguous view may start
    anywhere in its storage."""
    return t if t.data_ptr() % (vec * t.element_size()) == 0 else t.clone()


def _launched(name, err, **modes):
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    count_launch(LAUNCHES, name, **modes)


def chai_qk(q_rep, k_cache, pos, *, reps_per_group=1, window=0, ts=512):
    """Raw masked clustered scores over a dense cache, on the GPU.

    q_rep: (B, R, hd) (any float dtype; read as fp32); k_cache: (B, KV,
    S, hd) fp32 or bf16, or int8 codes read as their values (no scale,
    the Pallas body's cast), with KV * reps_per_group == R (rep j reads K
    row j // reps_per_group); pos: (B,). Returns (B, R, S) fp32:
    dot(q, k) * (1 / sqrt(hd)), exactly NEG_INF (-2e38) where s > pos or
    (window > 0 and pos - s >= window). ``ts`` must divide S, as in the
    Pallas wrapper; the kernel cuts S by ``qk_launch_config``. ONE
    launch."""
    k = k_cache.contiguous()
    s = k.shape[2]
    _tile_check("chai_qk", ts, s)
    b, r_total, hd, q, pos_i, out, cfg = _qk_inputs(
        "chai_qk", q_rep, k, pos, reps_per_group, tuple(_KV_DTYPES), s)
    if k.shape[0] != b:
        raise ValueError(f"chai_qk: K batch {k.shape[0]} != {b}")
    k = _aligned(k, cfg.vec)
    fn = _launcher("chai_qk", 4, 14)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), pos_i.data_ptr(),
                 out.data_ptr(), b, r_total, k.shape[1], s, hd,
                 reps_per_group, int(window), _KV_DTYPES[k.dtype],
                 *_qk_plan_args(cfg), stream)
    _launched("chai_qk", err, int8=k.dtype == torch.int8)
    return out


def chai_qk_i8(q_rep, k_cache_i8, k_scale, pos, *, reps_per_group=1,
               window=0, ts=512):
    """``chai_qk`` over an int8 cache (B, KV, S, hd), read one byte per
    element, with fp32 per-row scales k_scale (B, KV, S) applied after the
    dot: dot(k_i8, q) * k_scale[row] * (1 / sqrt(hd)), the Pallas
    kernel's order. Returns (B, R, S) fp32. ONE launch."""
    k = k_cache_i8.contiguous()
    s = k.shape[2]
    _tile_check("chai_qk_i8", ts, s)
    b, r_total, hd, q, pos_i, out, cfg = _qk_inputs(
        "chai_qk_i8", q_rep, k, pos, reps_per_group, (torch.int8,), s)
    if k.shape[0] != b or k_scale.shape != k.shape[:3]:
        raise ValueError(f"chai_qk_i8: K {tuple(k.shape)}, k_scale "
                         f"{tuple(k_scale.shape)}, batch {b}")
    if k_scale.dtype != torch.float32 or k_scale.device != k.device:
        raise TypeError(f"chai_qk_i8: k_scale must be fp32 on {k.device}; "
                        f"got {k_scale.dtype} on {k_scale.device}")
    k = _aligned(k, cfg.vec)
    ks = k_scale.contiguous()
    fn = _launcher("chai_qk_i8", 5, 13)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), ks.data_ptr(), pos_i.data_ptr(),
                 out.data_ptr(), b, r_total, k.shape[1], s, hd,
                 reps_per_group, int(window), *_qk_plan_args(cfg), stream)
    _launched("chai_qk_i8", err)
    return out


def paged_chai_qk(q_rep, k_pool, bt, pos, *, reps_per_group=1, window=0):
    """``chai_qk`` over a K page pool (nP, KV, page, hd), fp32, bf16 or
    int8 codes read as values, read in place through the block table bt
    (B, P): position s of row b is row s % page of page bt[b, s // page].
    Returns (B, R, P * page) fp32, bitwise equal to ``chai_qk`` on the
    same logical K (the same plan and order). ONE launch."""
    if not k_pool.is_contiguous():
        raise ValueError("paged_chai_qk: k_pool must be contiguous (pools "
                         "are read in place, never copied)")
    n_pages, page = bt.shape[1], k_pool.shape[2]
    b, r_total, hd, q, pos_i, out, cfg = _qk_inputs(
        "paged_chai_qk", q_rep, k_pool, pos, reps_per_group,
        tuple(_KV_DTYPES), n_pages * page)
    if bt.shape != (b, n_pages):
        raise ValueError(f"paged_chai_qk: bt {tuple(bt.shape)} for batch {b}")
    if k_pool.data_ptr() % (cfg.vec * k_pool.element_size()):
        raise ValueError(f"paged_chai_qk: k_pool must be aligned to "
                         f"{cfg.vec * k_pool.element_size()} bytes (its "
                         "loads; pools are read in place, never copied)")
    bt_i = _small(bt, q.device)
    fn = _launcher("paged_chai_qk", 5, 15)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k_pool.data_ptr(), bt_i.data_ptr(),
                 pos_i.data_ptr(), out.data_ptr(), b, r_total,
                 k_pool.shape[1], n_pages, page, hd, reps_per_group,
                 int(window), _KV_DTYPES[k_pool.dtype], *_qk_plan_args(cfg),
                 stream)
    _launched("paged_chai_qk", err, int8=k_pool.dtype == torch.int8)
    return out


class SoftmaxLaunch(NamedTuple):
    """How a ``row_softmax`` call is cut: each row of S floats is
    ``n_vec`` loads of ``vw`` floats (16-byte loads when S % 4 == 0), held
    ``vecs`` loads a thread by ``team`` threads of each of ``cluster``
    blocks (a thread block cluster when > 1), ``rows_per_block`` rows a
    block (cluster 1); ``chunks`` passes of the threads' loads cover the
    row (1: the row is held in registers and read once; more: it is read
    twice); ``blocks`` in the grid; ``smem_bytes`` of static shared
    memory a block."""
    vw: int
    n_vec: int
    vecs: int
    team: int
    rows_per_block: int
    cluster: int
    chunks: int
    blocks: int
    smem_bytes: int


# row_softmax.cu: kMaxThreads (a block's threads), the loads a thread
# holds at most (the kernel's largest kV), the largest cluster (the
# portable size) and the static shared memory (an (m, l) pair per warp and
# the block's). A row one block can hold at SOFTMAX_BLOCK_VECS loads a
# thread takes the fewest warps that do (measured on the H100 at 100 rows
# of 1024: 2-4 loads a thread ran in 0.0019 ms, 8 in 0.0020, 1 in 0.0021;
# tools/softmax_ab.py); a longer one a cluster of blocks of
# SOFTMAX_THREADS at up to SOFTMAX_MAX_VECS loads. The plan spreads a
# short grid over more blocks of a row's cluster until it holds
# SOFTMAX_FILL blocks (two a SM of the H100's 132), and packs several rows
# into a block only while the grid keeps that many.
SOFTMAX_THREADS = 256
SOFTMAX_BLOCK_VECS = 4
SOFTMAX_MAX_VECS = 8
SOFTMAX_MAX_CLUSTER = 8
SOFTMAX_SMEM = (SOFTMAX_THREADS // 32 + 1) * 8
SOFTMAX_FILL = 2 * 132


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def softmax_launch_config(rows: int, s: int) -> SoftmaxLaunch:
    """The launch of one ``row_softmax`` call on ``rows`` rows of ``s``
    floats: the fewest threads that hold a row at ``SOFTMAX_BLOCK_VECS``
    loads each, in whole warps of one block (a power of two up to 256);
    a longer row takes a cluster of blocks of 256 (at least 2, at most 8
    at ``SOFTMAX_MAX_VECS`` loads a thread, more while the grid is short
    of ``SOFTMAX_FILL`` blocks); each thread then holds the fewest loads
    (a power of two) that cover the row, and a row longer than 8 blocks
    of 256 threads of 8 loads (S > 65,536 at 16-byte loads, 16,384 at
    4-byte ones) is streamed in chunks of that size."""
    vw = 4 if s % 4 == 0 else 1
    n_vec = -(-s // vw)
    need = -(-n_vec // SOFTMAX_BLOCK_VECS)
    if need <= SOFTMAX_THREADS:
        team, cluster = 32 * _pow2_at_least(-(-need // 32)), 1
    else:
        team = SOFTMAX_THREADS
        cluster = min(SOFTMAX_MAX_CLUSTER,
                      max(2, -(-n_vec // (team * SOFTMAX_MAX_VECS))))
        while cluster < SOFTMAX_MAX_CLUSTER and rows * cluster < SOFTMAX_FILL:
            cluster += 1
    threads = team * cluster
    vecs = min(SOFTMAX_MAX_VECS, _pow2_at_least(-(-n_vec // threads)))
    chunks = -(-n_vec // (threads * vecs))
    per_block = 1 if cluster > 1 else max(
        1, min(SOFTMAX_THREADS // team, rows // SOFTMAX_FILL))
    blocks = rows * cluster if cluster > 1 else -(-rows // per_block)
    return SoftmaxLaunch(vw, n_vec, vecs, team, per_block, cluster, chunks,
                         blocks, SOFTMAX_SMEM)


def row_softmax(scores):
    """Masked softmax of each (b, rep) row of raw scores (B, R, S) fp32,
    on the GPU: p = exp(x - max(max(x), -1e30)), p / max(sum(p), 1e-37);
    a row masked everywhere gives zeros. Each row is read once from device
    memory and written once (twice read past 65,536 entries), cut by
    ``softmax_launch_config``. Returns (B, R, S) fp32. ONE launch."""
    if scores.device.type != "cuda":
        raise ValueError(f"row_softmax launches a CUDA kernel; got tensors "
                         f"on {scores.device}")
    if scores.dtype != torch.float32 or scores.ndim != 3:
        raise TypeError(f"row_softmax: scores must be (B, R, S) fp32; got "
                        f"{tuple(scores.shape)} {scores.dtype}")
    b, r, s = scores.shape
    cfg = softmax_launch_config(b * r, s)
    x = _aligned(scores.contiguous(), cfg.vw)
    out = torch.empty_like(x)
    fn = _launcher("row_softmax", 2, 8)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), b * r, s, cfg.vw, cfg.vecs,
                 cfg.team, cfg.rows_per_block, cfg.cluster, cfg.chunks,
                 stream)
    _launched("row_softmax", err)
    return out


class AvLaunch(NamedTuple):
    """How a ``chai_av`` / ``paged_chai_av`` call is cut: each (b, h)
    unit's S into ``n_split`` ranges of ``tiles_per_split`` whole tiles
    (the last may be shorter), ``vec`` V elements a thread loads at once,
    and the fp32 ``scratch_floats`` of the split partials (0 when not
    split). The kernel cuts a row wider than 128 loads into column
    groups itself."""
    n_split: int
    tiles_per_split: int
    vec: int
    scratch_floats: int


def av_launch_config(b: int, h: int, n_tiles: int, hd: int,
                     elem_bytes: int) -> AvLaunch:
    """The launch of one AV call on ``b`` batch rows of ``h`` heads,
    ``n_tiles`` tiles of S each (dense: S / ts; paged: the pages) and
    rows of ``hd`` elements of ``elem_bytes``: ``split_plan`` over the
    b * h units (at least one split), so the dense and the paged call at
    equal shapes cut alike, and the widest load of 16, 8, 4 or 2 bytes
    whose element count divides hd (at least two elements: hd is even).
    It reads no layout and no ``pos``."""
    n_split, per = split_plan(b, h, n_tiles)
    n_split = max(n_split, 1)
    vec = load_width(hd, elem_bytes)
    return AvLaunch(n_split, per, vec,
                    b * h * n_split * hd if n_split > 1 else 0)


def av_scratch(cfg: AvLaunch, units: int, dev, stream):
    """(partials, counter) of an AV launch: ``cfg.scratch_floats`` fp32
    in one ``torch.empty`` (the kernel reads no slot it has not written)
    and the (device, stream)'s ticket counters, ``units`` of them; both
    None when the call is not split."""
    if cfg.n_split == 1:
        return None, None
    return (torch.empty(cfg.scratch_floats, dtype=torch.float32, device=dev),
            _unit_counter(units, dev, stream))


def _av_inputs(name, a, v, h2c, h):
    """Checks shared by the AV wrappers; returns (b, R, a fp32, h2c as a
    (B, H) int32 tensor, the (B, H, hd) output)."""
    if a.device.type != "cuda" or v.device != a.device:
        raise ValueError(f"{name} launches a CUDA kernel; got A on "
                         f"{a.device} and V on {v.device}")
    if a.dtype != torch.float32 or a.ndim != 3:
        raise TypeError(f"{name}: A must be (B, R, S) fp32; got "
                        f"{tuple(a.shape)} {a.dtype}")
    if v.dtype not in _KV_DTYPES:
        raise TypeError(f"{name}: V must be fp32, bf16 or int8 codes; got "
                        f"{v.dtype}")
    b, r_total = a.shape[:2]
    if h2c.ndim == 1:
        h2c = h2c.expand(b, h2c.shape[0])
    if h2c.shape != (b, h):
        raise ValueError(f"{name}: h2c {tuple(h2c.shape)} for (B, H) = "
                         f"({b}, {h})")
    hd = v.shape[3]
    if hd % 2:
        raise ValueError(f"{name}: head_dim {hd} must be even (loads of at "
                         "least two elements)")
    out = torch.empty((b, h, hd), dtype=torch.float32, device=a.device)
    return b, r_total, a.contiguous(), _small(h2c, a.device), out


def chai_av(a, v_cache, h2c, *, ts=512):
    """Broadcast-and-accumulate over a dense V cache, on the GPU.

    a: (B, R, S) fp32 normalized clustered scores; v_cache: (B, H, S, hd)
    fp32 or bf16, or int8 codes read as their values (no scale: the
    share_values pipeline's clustered V), one V row per head; h2c: (B, H)
    or (H,), head -> A row. Returns (B, H, hd) fp32: out[b, h] = sum over
    every s of a[b, h2c[b, h], s] * v[b, h, s] (no pos cut: A is zero
    past pos because the softmax made it so). ``ts`` must divide S, as in
    the Pallas wrapper; it is the tile of the split plan
    (``av_launch_config``), so at ts == page this call and
    ``paged_chai_av`` are bitwise equal. ONE launch."""
    v = v_cache.contiguous()
    b_v, h, s, hd = v.shape
    _tile_check("chai_av", ts, s)
    b, r_total, af, h2c_i, out = _av_inputs("chai_av", a, v, h2c, h)
    if b_v != b or af.shape[2] != s:
        raise ValueError(f"chai_av: A {tuple(a.shape)} against V "
                         f"{tuple(v.shape)}")
    ts = fused_tile_size(ts, s)
    cfg = av_launch_config(b, h, s // ts, hd, v.element_size())
    if v.data_ptr() % (cfg.vec * v.element_size()):
        v = v.clone()               # a fresh allocation is aligned
    fn = _launcher("chai_av", 6, 10)
    with torch.cuda.device(af.device):
        stream = torch.cuda.current_stream(af.device).cuda_stream
        scratch, counter = av_scratch(cfg, b * h, af.device, stream)
        err = fn(af.data_ptr(), v.data_ptr(), h2c_i.data_ptr(),
                 out.data_ptr(), _ptr(scratch), _ptr(counter), b, r_total,
                 h, s, hd, ts, cfg.n_split, cfg.tiles_per_split, cfg.vec,
                 _KV_DTYPES[v.dtype], stream)
    _launched("chai_av", err, int8=v.dtype == torch.int8)
    return out


def paged_chai_av(a, v_pool, bt_v, h2c):
    """``chai_av`` over a V page pool (nP, H, page, hd), fp32, bf16 or
    int8 codes, read in place through bt_v (B, P): head h's position s is
    row s % page of page bt_v[b, s // page]; the tile is the page. a: (B,
    R, P * page). Returns (B, H, hd) fp32. ONE launch."""
    if not v_pool.is_contiguous():
        raise ValueError("paged_chai_av: v_pool must be contiguous (pools "
                         "are read in place, never copied)")
    h, page = v_pool.shape[1], v_pool.shape[2]
    n_pages = bt_v.shape[1]
    if a.shape[2] != n_pages * page or bt_v.shape != (a.shape[0], n_pages):
        raise ValueError(f"paged_chai_av: A {tuple(a.shape)} against "
                         f"{n_pages} pages of {page} (bt_v "
                         f"{tuple(bt_v.shape)})")
    b, r_total, af, h2c_i, out = _av_inputs("paged_chai_av", a, v_pool, h2c,
                                            h)
    hd = v_pool.shape[3]
    cfg = av_launch_config(b, h, n_pages, hd, v_pool.element_size())
    if v_pool.data_ptr() % (cfg.vec * v_pool.element_size()):
        raise ValueError(f"paged_chai_av: v_pool must be aligned to "
                         f"{cfg.vec * v_pool.element_size()} bytes (its "
                         "loads; pools are read in place, never copied)")
    bt_i = _small(bt_v, af.device)
    fn = _launcher("paged_chai_av", 7, 10)
    with torch.cuda.device(af.device):
        stream = torch.cuda.current_stream(af.device).cuda_stream
        scratch, counter = av_scratch(cfg, b * h, af.device, stream)
        err = fn(af.data_ptr(), v_pool.data_ptr(), bt_i.data_ptr(),
                 h2c_i.data_ptr(), out.data_ptr(), _ptr(scratch),
                 _ptr(counter), b, r_total, h, n_pages, page, hd,
                 cfg.n_split, cfg.tiles_per_split, cfg.vec,
                 _KV_DTYPES[v_pool.dtype], stream)
    _launched("paged_chai_av", err, int8=v_pool.dtype == torch.int8)
    return out
