"""The models on DTensors: each layer that holds a sharded weight runs its
plain code on the local shards through ``torch.distributed.tensor.
experimental.local_map`` with placements chosen here, and returns a
DTensor whose placements say what the local results are.

Every layer function of :mod:`repro_torch.models` runs its products,
lookups, attention, MoE dispatch, Mamba mixer and cache writes through
the helpers here.  On plain tensors each helper calls the plain function
at once, so the unsharded model runs the same ops as before.  Under a
mesh (params, batch and caches DTensors on a ``DeviceMesh``, as
:mod:`repro_torch.launch.steps` places them) the helpers place the
operands; elementwise ops, norms over the unsharded model dim, rotary
embeddings and the residual adds stay DTensor ops.  DTensor's own rules
are not used for the products: they may all-gather a weight, which would
replicate the model quietly.  The choices, and the collective each costs:

* :func:`product` — a two-operand product (projection, MLP, unembedding)
  runs locally; a weight sharded on a kept dim shards the result, one
  sharded on a contracted dim (``wo``, ``w_down``, Mamba's ``out``) leaves
  a ``Partial`` sum.  An activation sharded where the weight needs it
  whole is gathered (sequence parallelism's all-gather); a weight is
  never gathered.
* :func:`residual` — a ``Partial`` sublayer output is reduced onto the
  residual stream's placements: one all-reduce of (B, S, d) per sublayer
  (a reduce-scatter under sequence parallelism).
* :func:`embed` — a vocab-sharded table is looked up locally (tokens
  outside the rank's slice read zeros), then reduced: one all-reduce of
  (B, S, d).
* :func:`attention` — the flash kernel takes raw pointers, so it must see
  the local shard: batch over the data axes, heads over the model axis.
  A local query head reads global KV head ``h_global // group`` when the
  KV heads are replicated (they do not divide the model axis).  No
  collective.
* :func:`nll_mean` — vocab-sharded logits: the row max (all-reduce max
  of (B, S)), the sum of exponentials and the gold logit (all-reduce of
  (B, S) each) from the local slices; the mean over batch shards is left
  a ``Partial`` sum, reduced once a step with the gradients.
* :func:`moe` — the capacity dispatch (top-k, slot cumsum, one-hot
  gathers) on the replicated router, each rank running its own experts
  (expert-parallel) or its slice of every expert's ff (tensor-parallel):
  a ``Partial`` output.  A dispatch group that spans data shards (fewer
  local tokens than a group) gathers the tokens over the data axes first.
* :func:`mamba_mix` — Mamba-2's conv, segment sums and chunk recurrence
  per local head (no collective); the gated norm's mean over the sharded
  inner dim is one all-reduce of (B, S).
* :func:`write_cache` — the in-place KV-cache write at a position, on a
  cache whose sequence dim may be sharded (flash-decoding layout): each
  rank writes the part of the window its shard holds.  No collective.

A mesh dimension of size 1 shards nothing: there a local tensor is the
whole value, and the plain code runs unchanged, so a one-rank mesh gives
the unsharded results bit for bit.
"""

from __future__ import annotations

import functools
from typing import Callable, List, Optional, Sequence

import torch


@functools.cache
def _dtensor_type():
    from torch.distributed.tensor import DTensor

    return DTensor


def is_dtensor(x) -> bool:
    return isinstance(x, _dtensor_type())


# ---------------------------------------------------------------------- #
# plumbing
# ---------------------------------------------------------------------- #

def _R():
    from torch.distributed.tensor import Replicate

    return Replicate()


def _S(d: int):
    from torch.distributed.tensor import Shard

    return Shard(d)


def _Pt(op: str = "sum"):
    from torch.distributed.tensor import Partial

    return Partial(op)


def _dt(x, mesh):
    """``x`` as a DTensor on ``mesh``; a plain tensor is a value every rank
    holds whole."""

    from torch.distributed.tensor import DTensor

    if is_dtensor(x):
        return x
    return DTensor.from_local(x, mesh, [_R()] * mesh.ndim, run_check=False)


def _to(x, placements):
    placements = tuple(placements)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def place(x, mesh, placements):
    """``x`` (a DTensor, or a plain tensor every rank holds whole) as a
    DTensor on ``mesh`` under ``placements``."""

    return _to(_dt(x, mesh), placements)


def _live(mesh) -> List[int]:
    """The mesh dims of more than one rank."""

    return [i for i in range(mesh.ndim) if mesh.size(i) > 1]


def local_shape_and_offset(shape, mesh, placements):
    """(local shape, global offset) of this rank's shard of a tensor of
    ``shape`` under ``placements``: each mesh dim, in order, splits the
    current chunk of its tensor dim as ``torch.chunk`` does.  Pure Python
    on the mesh coordinate, so it runs under ``FakeTensorMode`` too."""

    coord = mesh.get_coordinate()
    local, off = list(shape), [0] * len(shape)
    for i, p in enumerate(placements):
        if not p.is_shard():
            continue
        d, n = p.dim, mesh.size(i)
        c = -(-local[d] // n)
        start = min(coord[i] * c, local[d])
        local[d] = max(0, min(c, local[d] - start))
        off[d] += start
    return tuple(local), tuple(off)


def _offsets(x) -> tuple:
    """This rank's offset along every dim of the DTensor ``x``."""

    return local_shape_and_offset(tuple(x.shape), x.device_mesh, x.placements)[1]


def _local(fn: Callable, args: Sequence, in_pls: Sequence, out_pls, mesh):
    """``fn`` on the local shards of ``args``, each first placed as
    ``in_pls`` says (None: passed as is); the results are DTensors under
    ``out_pls`` (one placement list, or a tuple of them for a tuple of
    results).

    Gradients: a replicated input on a mesh dim that some input shards
    feeds a split computation, so its gradient there is a ``Partial`` sum
    (a data-replicated weight's over the batch shards, a model-replicated
    activation's over the head shards); elsewhere a gradient has its
    input's placement."""

    from torch.distributed.tensor.experimental import local_map

    args = [_to(a, p) if p is not None else a for a, p in zip(args, in_pls)]
    in_pls = [tuple(a.placements) if is_dtensor(a) else None for a in args]
    split = [
        mesh.size(i) > 1 and any(p is not None and p[i].is_shard() for p in in_pls)
        for i in range(mesh.ndim)
    ]
    grad_pls = [
        None if p is None else tuple(
            _Pt() if (split[i] and q.is_replicate()) else q for i, q in enumerate(p)
        )
        for p in in_pls
    ]
    return local_map(
        fn, out_placements=out_pls, in_placements=tuple(in_pls),
        in_grad_placements=tuple(grad_pls), device_mesh=mesh,
    )(*args)


def _no_partials(x):
    """``x`` with every ``Partial`` placement reduced to ``Replicate``."""

    return _to(x, [_R() if p.is_partial() else p for p in x.placements])


def whole_along(x, dim: int):
    """``x`` with dim ``dim`` gathered on every mesh dim that splits it
    (and no partials): e.g. the vocab before a greedy argmax."""

    dim = dim % x.ndim
    return _to(x, [
        _R() if (p.is_partial() or p.is_shard(dim)) else p for p in x.placements
    ])


def accumulate(total, x):
    """``total + x`` for a running sum (the MoE aux loss over layers): where
    one term is a ``Partial`` DTensor and the other a value every rank
    holds (a plain zero, or a replicated one), the latter is put in the
    former's placements first, locally (whole on each partial dim's first
    rank, zero on the others), so the sum stays unreduced until the step
    reads it (DTensor's own rule may reduce the ``Partial`` term instead,
    once a layer and microbatch)."""

    if not (is_dtensor(total) or is_dtensor(x)):
        return total + x
    mesh = (x if is_dtensor(x) else total).device_mesh
    a, b = _dt(total, mesh), _dt(x, mesh)
    if _partial_only(a) and not _partial_only(b) and _replicated(b):
        b = _as_partial(b, a.placements)
    elif _partial_only(b) and not _partial_only(a) and _replicated(a):
        a = _as_partial(a, b.placements)
    return a + b


def _partial_only(x) -> bool:
    return any(p.is_partial() for p in x.placements) and not any(
        p.is_shard() for p in x.placements
    )


def _replicated(x) -> bool:
    return all(p.is_replicate() for p in x.placements)


def _as_partial(x, placements):
    """A replicated DTensor ``x`` under ``placements`` (partial sums and
    replicas), no collective: its value on the first rank of every
    partial-sum dim, zero on the others."""

    from torch.distributed.tensor import DTensor

    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    local = x.to_local()
    first = all(
        coord[i] == 0 for i, p in enumerate(placements)
        if p.is_partial() and p.reduce_op == "sum"
    )
    if not first:
        local = torch.zeros_like(local)
    return DTensor.from_local(local, mesh, placements, run_check=False)


def residual(x, o):
    """``x + o``: the sublayer output ``o`` (a ``Partial`` sum over the
    model axis, in general) reduced onto ``x``'s placements first."""

    if not is_dtensor(o):
        return x + o
    x = _dt(x, o.device_mesh)
    return x + _to(o, x.placements)


# ---------------------------------------------------------------------- #
# products
# ---------------------------------------------------------------------- #

def product(fn: Callable, spec: str, a, w):
    """``fn(a, w)`` of an activation ``a`` and a weight ``w``, a product
    whose dims the einsum ``spec`` ("bsd,df->bsf") names.  Per mesh dim:
    the letter sharded in either operand shards every operand holding it;
    the result is sharded on it when the result holds it, else a
    ``Partial`` sum.  Where ``a`` and ``w`` shard different letters, ``a``
    is gathered."""

    if not (is_dtensor(a) or is_dtensor(w)):
        return fn(a, w)
    ins, out = spec.split("->")
    la, lw = ins.split(",")
    mesh = (a if is_dtensor(a) else w).device_mesh
    a, w = _no_partials(_dt(a, mesh)), _no_partials(_dt(w, mesh))
    pa, pw, po = list(a.placements), list(w.placements), []
    for i in range(mesh.ndim):
        if mesh.size(i) == 1:
            po.append(_R())
            continue
        xa = la[pa[i].dim] if pa[i].is_shard() else None
        xw = lw[pw[i].dim] if pw[i].is_shard() else None
        letter = xw or xa
        pa[i] = _S(la.index(letter)) if letter and letter in la else _R()
        pw[i] = _S(lw.index(letter)) if letter and letter in lw else _R()
        if letter is None:
            po.append(_R())
        elif letter in out:
            po.append(_S(out.index(letter)))
        else:
            po.append(_Pt())
    return _local(fn, [a, w], [pa, pw], po, mesh)


# ---------------------------------------------------------------------- #
# embedding and cross entropy
# ---------------------------------------------------------------------- #

def embed(tok, tokens):
    """``tok[tokens]`` of a (possibly vocab-sharded) table, reduced over
    the model axis."""

    if not is_dtensor(tok):
        return tok[tokens]
    mesh = tok.device_mesh
    tokens = _no_partials(_dt(tokens, mesh))
    tok = _no_partials(tok)
    pt, pi, po = [], [], []
    for i in range(mesh.ndim):
        t, x = tok.placements[i], tokens.placements[i]
        if mesh.size(i) == 1:
            pt.append(t), pi.append(x), po.append(_R())
            continue
        if t.is_shard(0):  # vocab slice: tokens whole on this dim
            pt.append(t), pi.append(_R()), po.append(_Pt())
        else:
            pt.append(_R()), pi.append(x), po.append(x)
    off = 0  # the table's vocab offset is read on the placed table
    placed = _to(tok, pt)
    if any(p.is_shard(0) for p in placed.placements):
        off = _offsets(placed)[0]

    def lookup(t, ids):
        if t.shape[0] == tok.shape[0]:
            return t[ids]
        local = ids.long() - off
        ok = (local >= 0) & (local < t.shape[0])
        rows = t[local.clamp(0, t.shape[0] - 1)]
        return rows * ok[..., None].to(rows.dtype)

    out = _local(lookup, [placed, tokens], [pt, pi], po, mesh)
    return _no_partials(out)


def nll_mean(logits, labels, mask=None):
    """The mean of ``logsumexp(logits) - logits[labels]`` over the rows
    of DTensor logits (..., V), the vocab possibly sharded
    (:func:`_logz_gold`), weighted by ``mask`` when given.  Rows split
    over the data axes leave a ``Partial`` sum of each shard's sum / the
    row count — the loss stays unreduced until the step reads it, as the
    gradients do; a ``mask`` needs its global count, one all-reduce."""

    logz, gold = _logz_gold(logits, labels)
    nll = logz - gold
    mesh = nll.device_mesh
    rows = list(nll.placements)
    if mask is not None:
        mask = _to(_no_partials(_dt(mask, mesh)), rows).float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    split = [mesh.size(i) > 1 and p.is_shard() for i, p in enumerate(rows)]
    if not any(split):
        return torch.mean(nll)
    n = nll.numel()
    return _local(
        lambda t: t.sum() / n, [nll], [rows],
        [_Pt() if sp else _R() for sp in split], mesh,
    )


def _logz_gold(logits, labels):
    """(logz, gold) of DTensor logits (..., V), the vocab possibly
    sharded: ``logsumexp`` and the labels' logits, each (...) with the
    logits' placements on the other dims."""

    mesh = logits.device_mesh
    logits = _no_partials(logits)
    vdim = logits.ndim - 1
    lp = list(logits.placements)
    vocab_split = [i for i in _live(mesh) if lp[i].is_shard(vdim)]
    rows = [_R() if (p.is_shard(vdim) or mesh.size(i) == 1) else p for i, p in enumerate(lp)]
    lab_pl = [_R() if p.is_shard(vdim) else p for p in lp]
    labels = _to(_no_partials(_dt(labels, mesh)), lab_pl)
    if not vocab_split:
        def plain(lg, lab):
            gold = torch.gather(lg, -1, lab[..., None].long())[..., 0]
            return torch.logsumexp(lg, dim=-1), gold

        return _local(plain, [logits, labels], [lp, lab_pl], (rows, rows), mesh)

    off = _offsets(logits)[vdim]
    partial = [_Pt() if i in vocab_split else r for i, r in enumerate(rows)]
    m = _local(
        lambda lg: lg.detach().amax(dim=-1), [logits], [lp],
        [_Pt("max") if i in vocab_split else r for i, r in enumerate(rows)], mesh,
    )
    m = _to(m, rows)

    def parts(lg, mx, lab):
        s = torch.exp(lg - mx[..., None]).sum(dim=-1)
        local = lab.long() - off
        ok = (local >= 0) & (local < lg.shape[-1])
        g = torch.gather(lg, -1, local.clamp(0, lg.shape[-1] - 1)[..., None])[..., 0]
        return s, g * ok.to(g.dtype)

    s, gold = _local(parts, [logits, m, labels], [lp, rows, lab_pl], (partial, partial), mesh)
    return m + torch.log(_to(s, rows)), _to(gold, rows)


# ---------------------------------------------------------------------- #
# attention
# ---------------------------------------------------------------------- #

def attention(fn: Callable, q, *kvs):
    """``fn(q, *kvs)`` (q (B,Sq,H,hd), each of ``kvs`` (B,Sk,KV,...) →
    (B,Sq,H,hd)) on the local shards: batch over its mesh dims, query
    heads over theirs, KV heads sharded with them when they divide, else
    whole and sliced to the local query heads' groups.  A local slice
    whose query heads do not cover their KV groups evenly raises, since
    ``fn`` maps local head j to local KV head j // (heads / KV heads)."""

    if not is_dtensor(q):
        return fn(q, *kvs)
    mesh = q.device_mesh
    q = _no_partials(_dt(q, mesh))
    kvs = [_no_partials(_dt(t, mesh)) for t in kvs]
    H, KV = q.shape[2], kvs[0].shape[2]
    group = H // KV
    pq, pk = list(q.placements), list(kvs[0].placements)
    for i in range(mesh.ndim):
        if mesh.size(i) == 1:
            continue
        Q, K = pq[i], pk[i]
        if not (Q.is_shard(0) or Q.is_shard(2)):
            Q = _R()
        if Q.is_shard(0):
            K = _S(0)
        elif Q.is_shard(2) and K.is_shard(2) and KV % mesh.size(i) == 0:
            K = _S(2)
        else:
            K = _R()
        pq[i], pk[i] = Q, K
    q = _to(q, pq)
    kvs = [_to(t, pk) for t in kvs]
    (_, _, hl, _), (_, _, h0, _) = local_shape_and_offset(tuple(q.shape), mesh, pq)
    kv0 = _offsets(kvs[0])[2]
    kvl = -(-(h0 + hl) // group) - h0 // group
    if hl and (hl % kvl or any(
        (h0 + j) // group - h0 // group != j // (hl // kvl) for j in range(hl)
    )):
        raise NotImplementedError(
            f"attention: local query heads [{h0}, {h0 + hl}) do not cover their "
            f"KV groups of {group} evenly"
        )

    def local(ql, *kl):
        lo = h0 // group - kv0
        hi = -(-(h0 + hl) // group) - kv0
        if (lo, hi) != (0, kl[0].shape[2]):
            kl = [t[:, :, lo:hi] for t in kl]
        return fn(ql, *kl)

    return _local(local, [q] + kvs, [pq] + [pk] * len(kvs), pq, mesh)


def seq_sharded(cache) -> bool:
    """Whether a DTensor cache (B,S,...) splits its sequence dim over
    more than one rank (the flash-decoding layout)."""

    return is_dtensor(cache) and any(
        p.is_shard(1) and cache.device_mesh.size(i) > 1
        for i, p in enumerate(cache.placements)
    )


def write_cache(fn: Callable, caches: Sequence, news: Sequence, start: int):
    """``fn(caches, news, start)`` — an in-place write of the new (B,Sn,...)
    entries at sequence position ``start`` — on the local shards: each
    rank writes the part of [start, start+Sn) its cache shard holds (the
    sequence dim 1 may be sharded).  Returns the caches."""

    if not is_dtensor(caches[0]):
        fn(caches, news, start)
        return list(caches)
    mesh = caches[0].device_mesh
    pc = list(caches[0].placements)
    pn = [p if (p.is_shard() and p.dim != 1) else _R() for p in pc]
    news = [_to(_no_partials(_dt(n, mesh)), pn) for n in news]
    s0 = _offsets(caches[0])[1]
    sn = news[0].shape[1]

    def local(*ts):
        cs, ns = ts[: len(caches)], ts[len(caches):]
        smax = cs[0].shape[1]
        lo, hi = max(start, s0), min(start + sn, s0 + smax)
        if lo < hi:
            fn(cs, [n[:, lo - start : hi - start] for n in ns], lo - s0)
        return tuple(cs)

    _local(
        local, list(caches) + news, [pc] * len(caches) + [pn] * len(news),
        tuple(pc for _ in caches), mesh,
    )
    return list(caches)


# ---------------------------------------------------------------------- #
# MoE and Mamba
# ---------------------------------------------------------------------- #

def moe(routed: Callable, params: dict, x, group: int):
    """``routed(params, x, e0) -> (y, aux)`` — the routed experts' output
    and the aux loss over the token groups of ``x`` — on the local shards:
    ``x`` whole on the model axis (the router replicated), the expert
    weights as placed, ``e0`` the rank's first expert.  ``y`` is a
    ``Partial`` sum over the mesh dims that shard the experts; ``aux``, the
    mean over every group, a ``Partial`` of each rank's share.
    ``group`` is the dispatch group size of the unsharded call."""

    if not is_dtensor(x):
        return routed(params, x, 0)
    mesh = x.device_mesh
    x = _no_partials(x)
    names = ("router", "w_gate", "w_up", "w_down")
    ws = [_no_partials(_dt(params[n], mesh)) for n in names]
    split = [
        mesh.size(i) > 1 and any(w.placements[i].is_shard() for w in ws[1:])
        for i in range(mesh.ndim)
    ]
    # tokens stay split over the data axes when whole groups stay local
    px = [
        p if (mesh.size(i) == 1 or (p.is_shard(0) and not split[i])) else _R()
        for i, p in enumerate(x.placements)
    ]
    local, _ = local_shape_and_offset(tuple(x.shape), mesh, px)
    if (local[0] * local[1]) % group:
        px = [p if mesh.size(i) == 1 else _R() for i, p in enumerate(px)]
    # aux is a Partial sum of each rank's share, so its gradient is
    # counted once: on a data dim its shard's mean / n (the loss's mean
    # is left so too), on a dim that splits the experts 1/n of the whole
    # every rank there computes
    po, pa, n = [], [], 1
    for i, p in enumerate(px):
        if mesh.size(i) == 1:
            po.append(_R()), pa.append(_R())
            continue
        po.append(_Pt() if split[i] else p)
        if split[i] or p.is_shard():
            pa.append(_Pt())
            n *= mesh.size(i)
        else:
            pa.append(_R())
    x = _to(x, px)
    pw = [list(w.placements) for w in ws]
    e0 = _offsets(ws[1])[0]

    def local(xl, router, wg, wu, wd):
        y, aux = routed({"router": router, "w_gate": wg, "w_up": wu, "w_down": wd}, xl, e0)
        return y, aux / n if n > 1 else aux

    return _local(local, [x] + ws, [px] + pw, (po, pa), mesh)


def mamba_mix(core: Callable, params: dict, x, state: Optional[dict]):
    """``core(params, x, state) -> (y, z, new_state)`` — Mamba-2's
    projections, conv and SSD up to the gated norm, y and z (B,S,di) — on
    the local shards: the inner dim and heads over the model axis as the
    weights are placed (``wB`` / ``wC`` whole), the batch over the data
    axes.  Returns (y, z, new state); under a mesh the new state is the
    given ``state``, written in place (None when none was given)."""

    if not is_dtensor(x):
        return core(params, x, state)
    mesh = x.device_mesh
    x = _no_partials(x)
    names = ("wz", "wx", "wdt", "wB", "wC", "conv_x", "A_log", "D", "dt_bias")
    ws = [_no_partials(_dt(params[n], mesh)) for n in names]
    pw = [list(w.placements) for w in ws]
    px, py = [], []
    for i in range(mesh.ndim):
        p = x.placements[i]
        heads = ws[1].placements[i].is_shard() and mesh.size(i) > 1
        if mesh.size(i) == 1:
            px.append(p), py.append(_R())
        elif heads:
            px.append(_R()), py.append(_S(2))
        else:
            px.append(p if p.is_shard(0) else _R())
            py.append(px[-1])
    if any(
        mesh.size(i) > 1 and pw[1][i].is_shard() != pw[2][i].is_shard()
        for i in range(mesh.ndim)
    ):
        raise NotImplementedError(
            "Mamba mixer: the inner dim and the heads must be sharded alike"
        )
    args = [x] + ws
    pls = [px] + pw
    outs = (py, py)
    if state is not None:
        ssm, conv = state["ssm"], state["conv"]
        args += [ssm, conv]
        pls += [list(ssm.placements), list(conv.placements)]
        outs = (py, py, list(ssm.placements), list(conv.placements))

    def local(xl, *rest):
        p = dict(zip(names, rest[: len(names)]))
        st = None if state is None else {"ssm": rest[-2], "conv": rest[-1]}
        y, z, new = core(p, xl, st)
        return (y, z) if state is None else (y, z, new["ssm"], new["conv"])

    res = _local(local, args, pls, outs, mesh)
    return res[0], res[1], state
