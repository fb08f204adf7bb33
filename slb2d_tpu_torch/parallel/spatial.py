"""One phi_y grid cut over the "space" axis of a mesh, and the sharded
plain scan (impl=torch with shards>1).

The PyTorch counterpart of ``slb2d_tpu/parallel/spatial.py``.  Each slot
of the axis holds its (NHP, MP/S) slice of the state arrays and of the
m-indexed constants; everything else is replicated on every slot.  The
JAX package runs ``stencil.full_step`` under ``shard_map`` with two
injected operations; here a value of every local slot is a ``Slots``, on
which arithmetic, indexing, tensor methods and torch functions apply slot
by slot, and ``stencil.full_step`` runs unchanged on Slots with the same
two operations injected:

  * shift (``SpaceLayout.shift``): a ±1 shift in m rolls each slice and
    patches its wrapped column with the neighbouring slot's edge column
    (``collectives.exchange``), wrapping at the ends as ``ppermute`` does,
    so the result is ``torch.roll`` of the whole grid, bit for bit;
  * sum_m (``SpaceLayout.sum_m``): each slot's sum, then the slots' sums
    added in slot order, replicated on every slot.  A run gives the same
    bits whatever the layout of its slots over processes (the JAX
    package's psum has no fixed order).

The state arrays then come out bit for bit as on one device; the averages
and the records differ from one device's only by the order of the sums.
"""

from __future__ import annotations

import dataclasses
import operator

import torch

from ..ops import stencil
from .collectives import exchange, gather_slots
from .mesh import Mesh, process_count, process_index

# the StencilConsts fields indexed by m (the JAX package's spatial_specs)
M_FIELDS = ("a0", "a0_ghost", "phi", "col_main", "col_half", "w_av",
            "w_av_phi", "col_edge")
# the State fields indexed by m
M_STATE = ("a", "b", "a_hs", "b_hs")


def _count(x):
    """The slot count of the first Slots in x (nested in lists, tuples and
    dicts), else 0."""
    t = type(x)
    if t is Slots:
        return len(x.items)
    if t is list or t is tuple:
        for v in x:
            n = _count(v)
            if n:
                return n
    elif t is dict:
        return _count(list(x.values()))
    return 0


def _split(x, n):
    """x as its n per-slot values (a value that is no Slots, and holds
    none, is every slot's)."""
    t = type(x)
    if t is Slots:
        return x.items
    if (t is list or t is tuple or t is dict) and _count(x):
        if t is dict:
            cols = {k: _split(v, n) for k, v in x.items()}
            return [{k: c[i] for k, c in cols.items()} for i in range(n)]
        cols = [_split(v, n) for v in x]
        return [t(c[i] for c in cols) for i in range(n)]
    return [x] * n


def _map(fn, args, kwargs=None):
    """fn applied slot by slot; a tuple result becomes a tuple of Slots."""
    n = _count(args) or _count(kwargs)
    per = [_split(a, n) for a in args]
    if kwargs:
        kw = _split(kwargs, n)
        out = [fn(*[p[i] for p in per], **kw[i]) for i in range(n)]
    else:
        out = [fn(*[p[i] for p in per]) for i in range(n)]
    if isinstance(out[0], tuple):
        return tuple(Slots(v) for v in zip(*out))
    return Slots(out)


class Slots:
    """One value on each local slot, in slot order: a slice of a sharded
    array, or a replicated value.  Operators, indexing, methods and torch
    functions (``__torch_function__``) apply slot by slot; an attribute
    that is not a method is every slot's, as Slots, but dtype and shape,
    the same on every slot, are the first slot's."""

    def __init__(self, items):
        self.items = list(items)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        return _map(func, args, kwargs)

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        vals = [getattr(x, name) for x in self.items]
        if callable(vals[0]):
            return lambda *a, **k: _map(lambda x, *aa, **kk: getattr(
                x, name)(*aa, **kk), (self,) + a, k)
        if name in ("dtype", "shape"):       # the same on every slot
            return vals[0]
        return Slots(vals)

    def __len__(self):
        return len(self.items[0])

    def __repr__(self):
        return f"Slots({self.items!r})"

    __hash__ = None


def _binop(op, reflected=False):
    def fn(self, other):
        if type(other) is Slots:
            pairs = zip(self.items, other.items)
        else:
            pairs = ((x, other) for x in self.items)
        if reflected:
            return Slots([op(b, a) for a, b in pairs])
        return Slots([op(a, b) for a, b in pairs])
    return fn


for _name, _op in (("add", operator.add), ("sub", operator.sub),
                   ("mul", operator.mul), ("truediv", operator.truediv),
                   ("mod", operator.mod), ("pow", operator.pow),
                   ("and", operator.and_), ("or", operator.or_)):
    setattr(Slots, f"__{_name}__", _binop(_op))
    setattr(Slots, f"__r{_name}__", _binop(_op, reflected=True))
for _name, _op in (("eq", operator.eq), ("ne", operator.ne),
                   ("lt", operator.lt), ("le", operator.le),
                   ("gt", operator.gt), ("ge", operator.ge),
                   ("getitem", operator.getitem)):
    setattr(Slots, f"__{_name}__", _binop(_op))
Slots.__neg__ = lambda self: _map(operator.neg, (self,))
Slots.__invert__ = lambda self: _map(operator.invert, (self,))


class SpaceLayout:
    """An (NHP, MP) grid over the `axis` slots of a mesh, or over a row of
    slots (one block of the combined sweep x space layout, Mesh.grid):
    slot i holds columns [i*L, (i+1)*L), L = MP / S.  Only MP % S == 0 is
    required (the JAX package also wants L a multiple of 128 for its
    kernel).  The processes that hold the slots run every operation across
    them together, through `group` where they are neither one process nor
    all of them."""

    def __init__(self, mesh, MP: int, axis: str = "space", group=None):
        self.slots = (mesh.axis_slots(axis) if isinstance(mesh, Mesh)
                      else list(mesh))
        self.S = len(self.slots)
        if MP % self.S:
            raise ValueError(
                f"shards={self.S} does not divide the padded grid MP={MP}; "
                f"pick a shard count dividing it (g-grid pads M+3 up to a "
                f"multiple of 128)")
        self.MP, self.L = MP, MP // self.S
        self.ranks = [s.rank for s in self.slots]
        rank = process_index()
        self.local = [i for i, r in enumerate(self.ranks) if r == rank]
        if not self.local or self.local != list(
                range(self.local[0], self.local[-1] + 1)):
            raise ValueError(f"process {rank} must hold a contiguous run "
                             f"of the layout's slots (ranks {self.ranks})")
        self.devices = [self.slots[i].device for i in self.local]
        self.home = self.devices[0]
        procs = sorted(set(self.ranks))
        if group is None and 1 < len(procs) < process_count():
            raise ValueError(f"slots of processes {procs} of "
                             f"{process_count()} need their process group")
        self.group = group
        self.n_per_rank = [self.ranks.count(r) for r in procs]
        self._neighbours = (None, None)   # see neighbour_cols

    # -- layout ---------------------------------------------------------------

    def cols(self, i: int) -> slice:
        return slice(i * self.L, (i + 1) * self.L)

    def scatter(self, x) -> Slots:
        """A host or device array (..., MP) -> each local slot's slice on
        its device, a tensor of its own (the kernel runner updates slices
        in place)."""
        x = torch.as_tensor(x)
        return Slots(x[..., self.cols(i)].to(d).clone(
            memory_format=torch.contiguous_format)
            for i, d in zip(self.local, self.devices))

    def replicate(self, x) -> Slots:
        """x on every local slot's device, a copy of its own on each."""
        x = torch.as_tensor(x)
        return Slots(x.to(d, copy=True) for d in self.devices)

    def gather_slots(self, local) -> list:
        """Every slot's tensor, in slot order, on the home device, from
        this process's slots' `local` tensors (across processes a
        collective of the layout's processes)."""
        return gather_slots(local, self.n_per_rank, self.group)

    def gather(self, x: Slots) -> torch.Tensor:
        """The whole (..., MP) array on the home device of every process
        (every process must call it: across processes it gathers)."""
        return torch.cat(self.gather_slots(x.items), dim=-1)

    def scatter_state(self, st: stencil.State) -> stencil.State:
        return stencil.State(**{
            f: (self.scatter if f in M_STATE else self.replicate)(
                getattr(st, f)) for f in stencil.FIELDS})

    def gather_state(self, st: stencil.State) -> stencil.State:
        """The whole state on the home device (replicated fields: the first
        local slot's)."""
        return stencil.State(**{
            f: (self.gather(getattr(st, f)) if f in M_STATE
                else getattr(st, f).items[0]) for f in stencil.FIELDS})

    def scatter_consts(self, c: stencil.StencilConsts):
        """c (best built on the host: no slot's device then holds the whole
        grid's m-indexed fields) with each slot's slice of those fields and
        its own copy of the others."""
        return dataclasses.replace(c, **{
            f: (self.scatter if f in M_FIELDS else self.replicate)(
                getattr(c, f))
            for f in (fl.name for fl in dataclasses.fields(c))})

    def bootstrap_state(self, c, model) -> stencil.State:
        """stencil.bootstrap_state on the slots, c the sharded consts: each
        slot's slice of the initial arrays and of the tiptoe half-step,
        the same bits as on one device, and no whole array on any
        device."""
        a = self.scatter(model.initial_a())
        a_hs, b_hs = stencil.tiptoe_half_step(
            c, a, float(stencil.bootstrap_cos_wdt(model)), shift=self.shift)
        return stencil.State(
            a=a, b=torch.zeros_like(a), a_hs=a_hs, b_hs=b_hs,
            **{f: self.replicate(v) for f, v in stencil.zero_carries(
                (), model.NHP, a.dtype).items()})

    # -- the operations across slots ------------------------------------------

    def shift(self, arr: Slots, dn: int, dm: int) -> Slots:
        """Value at (n+dn, m+dm) of the whole grid, each slot its slice:
        a local roll whose wrapped column comes from the neighbour (dm = ±1
        only; the ends wrap, as torch.roll of the whole grid does)."""
        if dm:
            if abs(dm) != 1:
                raise ValueError(f"shift by {dm} columns")
            recv = self.neighbour_cols(arr)[0 if dm > 0 else 1]
            rolled = []
            for x, r in zip(arr.items, recv.items):
                x = torch.roll(x, -dm, dims=-1)
                x[..., -1 if dm > 0 else 0] = r
                rolled.append(x)
            arr = Slots(rolled)
        if dn:
            arr = Slots(torch.roll(x, -dn, dims=-2) for x in arr.items)
        return arr

    def neighbour_cols(self, arr: Slots):
        """(slot i + 1's first column, slot i - 1's last column) of arr on
        every slot i, cyclic in i: one exchange for both directions, kept
        for the last array asked for (a half-step shifts each of its two
        neighbour arrays both ways, and the exact form twice)."""
        if self._neighbours[0] is arr:
            return self._neighbours[1]
        right = Slots(torch.empty_like(x[..., 0]) for x in arr.items)
        left = Slots(torch.empty_like(x[..., -1]) for x in arr.items)
        transfers = []
        for i in range(self.S):
            nxt, prv = (i + 1) % self.S, (i - 1) % self.S
            transfers.append((nxt, i, self.item(arr, nxt, 0),
                              self.item(right, i)))
            transfers.append((prv, i, self.item(arr, prv, -1),
                              self.item(left, i)))
        exchange(transfers, self.ranks)
        self._neighbours = (arr, (right, left))
        return right, left

    def fill_halos(self, ext: Slots, H: int):
        """Each slot's extended slice (..., L + 2H), its own columns at
        [H, H + L): its H halo columns on each side take the neighbours'
        edge columns, in place; the grid's two outer halos are left as
        they are (zeros: off the grid, as the tiling form's tiles read
        them)."""
        L = self.L
        own_last, own_first = slice(L, L + H), slice(H, 2 * H)
        left, right = slice(0, H), slice(L + H, L + 2 * H)
        transfers = []
        for i in range(self.S):
            if i > 0:
                transfers.append((i - 1, i, self.item(ext, i - 1, own_last),
                                  self.item(ext, i, left)))
            if i < self.S - 1:
                transfers.append((i + 1, i, self.item(ext, i + 1, own_first),
                                  self.item(ext, i, right)))
        exchange(transfers, self.ranks)

    def send(self, x: Slots, src: int, dsts):
        """Slot src's value of x to the slots dsts, in place."""
        exchange([(src, d, self.item(x, src), self.item(x, d))
                  for d in dsts if d != src], self.ranks)

    def item(self, x: Slots, i: int, cols=None):
        """Slot i's tensor of x (its columns cols), or None where slot i
        is another process's."""
        if i not in self.local:
            return None
        t = x.items[i - self.local[0]]
        return t if cols is None else t[..., cols]

    def sum_m(self, v: Slots) -> Slots:
        """The sum over m of the whole grid on every slot: each slot's sum
        over its columns, added in slot order."""
        parts = self.gather_slots([torch.sum(x, dim=-1) for x in v.items])
        tot = parts[0]
        for p in parts[1:]:
            tot = tot + p
        return self.replicate(tot)

