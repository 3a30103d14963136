"""The one traffic generator: a closed loop of requests, issued back to
back, numbered 0, 1, ... from the first warm-up request on.

A traffic file (``traffic/<name>.json``) gives its parameters:

- ``state``: ``"fresh"``, each request solves an input of its own, a field
  drawn from the seed; or ``"carried"``, a request has no input of its own
  and goes on from the program's state after the request before it (a time
  loop from the configuration's initial values), so every seed gives the
  same work and the seed draws only which answers are checked;
- for ``"fresh"``: ``terms``, ``amplitude`` [lo, hi], ``frequency`` [lo, hi],
  ``base``, ``scale``: request k's field is ``base + scale * sum_j a_j
  sin(p_j pi x) sin(q_j pi y) sin(r_j pi z)`` on the unit cube, with ``a_j ~
  U(lo, hi)`` and ``p_j, q_j, r_j`` whole numbers drawn uniformly from [lo,
  hi];
- ``compare``: how many of the window's answers are checked against the
  reference after the window, drawn from the seed (the last one always);
- ``trace_requests``: how many requests the profiler records in a
  ``--trace 1`` run, from the first request past the window's middle.

Request k's input under seed s is a function of ``(s, k)`` alone, so the
same seed gives the same inputs in the same order, however many a window
reaches, and a check can draw any of them again.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np

_REQUEST, _SAMPLE = 1, 2


def _rng(seed, *stream):
    seed = int(seed)
    return np.random.default_rng([int(seed < 0), abs(seed), *stream])


class SineField(NamedTuple):
    base: float
    scale: float
    terms: tuple  # of (amplitude, p, q, r)

    def axis_factors(self, coords):
        """For each term, its amplitude and the three 1-D factors
        ``sin(k pi coords)`` (numpy float64)."""
        c = np.asarray(coords, dtype=np.float64)
        return [(a, np.sin(p * math.pi * c), np.sin(q * math.pi * c),
                 np.sin(r * math.pi * c)) for a, p, q, r in self.terms]

    def on_lattice(self, coords):
        """The field at the lattice points ``coords`` x ``coords`` x
        ``coords``, float64 (numpy), shape (m, m, m)."""
        m = len(coords)
        out = np.zeros((m, m, m))
        for a, sx, sy, sz in self.axis_factors(coords):
            out += a * sx[:, None, None] * sy[None, :, None] * sz[None, None, :]
        return self.base + self.scale * out

    def on_lattice_torch(self, coords, dtype, device):
        """The same on the device, in ``dtype``: the 1-D factors are made in
        float64 on the host and the outer products on the device, in
        float64, then rounded once."""
        import torch

        m = len(coords)
        out = torch.zeros((m, m, m), dtype=torch.float64, device=device)
        for a, sx, sy, sz in self.axis_factors(coords):
            tx, ty, tz = (torch.as_tensor(v, device=device) for v in (sx, sy, sz))
            out += a * tx[:, None, None] * ty[None, :, None] * tz[None, None, :]
        return (self.base + self.scale * out).to(dtype)


class Traffic:
    """The requests of one traffic mix under one seed."""

    def __init__(self, params, seed):
        self.params = params
        self.seed = int(seed)
        self.carried = params["state"] == "carried"
        if not self.carried and params["state"] != "fresh":
            raise ValueError(f"state {params['state']!r}: 'fresh' or 'carried'")
        self.compare = int(params["compare"])
        self.trace_requests = int(params["trace_requests"])

    def _field(self, rng):
        p = self.params
        lo, hi = p["amplitude"]
        flo, fhi = p["frequency"]
        terms = []
        for _ in range(int(p["terms"])):
            a = float(rng.uniform(lo, hi))
            k = rng.integers(flo, fhi + 1, size=3)
            terms.append((a, int(k[0]), int(k[1]), int(k[2])))
        return SineField(float(p["base"]), float(p["scale"]), tuple(terms))

    def input(self, k):
        """Request k's input: its field, or None where the state is
        carried."""
        return None if self.carried else self._field(_rng(self.seed, _REQUEST, k))

    def sampler(self):
        return Reservoir(self.compare, _rng(self.seed, _SAMPLE))


class Reservoir:
    """A uniform sample of ``k - 1`` of the requests offered so far, drawn
    from the seed, plus the last one offered: the requests whose answers are
    checked.  Holds the answers of the sample only."""

    def __init__(self, k, rng):
        self.k = max(int(k), 1)
        self.rng = rng
        self.seen = 0
        self.kept = {}  # request index -> answer
        self.last = None

    def offer(self, index, answer):
        if self.last is not None:
            self._keep(*self.last)
        self.last = (index, answer)

    def _keep(self, index, answer):
        room = self.k - 1
        self.seen += 1
        if room <= 0:
            return
        if len(self.kept) < room:
            self.kept[index] = answer
            return
        j = int(self.rng.integers(0, self.seen))
        if j < room:
            del self.kept[sorted(self.kept)[j]]
            self.kept[index] = answer

    def sample(self):
        out = dict(self.kept)
        if self.last is not None:
            out[self.last[0]] = self.last[1]
        return dict(sorted(out.items()))
