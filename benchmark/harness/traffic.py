"""The one traffic generator. A mix is a data file of parameters
(``traffic/<mix>.json``); this module checks it and turns it and
``--seed`` into the inputs of a run. Every mix sets:

- ``kind``: the code that drives it, ``kinds/<kind>.py``, whose ``KEYS``
  name the further groups its mixes set and the keys of each;
- ``warmup_calls`` calls in set-up, ``sample`` calls of the window kept
  (a reservoir drawn from the seed, plus the last call) for the output
  check, ``trace_calls`` calls in the traced segment of a ``--trace 1``
  run; ``why``, in words.

The groups the kinds here read:

- ``rhs``: ``pool`` right-hand sides drawn on the device, uniform in
  [0, 1), made ahead in one call and cycled;
- ``shift``: each step's operator is L + sigma I with sigma = h^2 / dt
  (h the mesh width the mix states); step ``pos`` of a run takes dt in
  the ``pos mod levels``-th of ``levels`` log-spaced bins of
  10^dt_log10, from the smallest dt up (dt grows each step and starts
  again, as under an adaptive step), at a point of the bin's middle
  ``jitter`` share drawn for that call: every step's operator is its
  own. The steps are the same for every seed (the seed draws the
  right-hand sides): which setups the program can replay, and how much
  work a setup is, depend on the shifts, so shifts drawn from the seed
  made the seed change the work.

A key that no code reads is refused. The seed may be any whole number up
to 2**64 - 1; the same seed gives the same inputs."""

from __future__ import annotations

import numpy as np
import torch

COMMON_KEYS = {"why", "kind", "warmup_calls", "sample", "trace_calls"}

# sub-streams of a run's seed
_RHS, _SAMPLE, _PROBE, _SHIFT = 1, 3, 4, 5


def validate(mix: dict, keys: dict) -> None:
    """Refuse a mix that sets a key the kind's code does not read
    (``keys``: group -> its keys), or leaves one out."""
    extra = set(mix) - COMMON_KEYS - set(keys)
    missing = (COMMON_KEYS | set(keys)) - set(mix)
    if extra or missing:
        raise ValueError(f"mix of kind {mix.get('kind')!r}: keys nothing "
                         f"reads {sorted(extra)}, keys missing "
                         f"{sorted(missing)}")
    for group, sub in keys.items():
        if set(mix[group]) != set(sub):
            raise ValueError(f"mix group {group!r} has keys "
                             f"{sorted(mix[group])}; its kind reads "
                             f"{sorted(sub)}")


def substream(seed: int, *which: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed), *which]))


def torch_seed(seed: int, which: int) -> int:
    return int(substream(seed, which).integers(0, 2 ** 63 - 1))


def make_rhs(rhs: dict, n: int, dtype, device, seed: int) -> torch.Tensor:
    """(pool, n) right-hand sides, uniform in [0, 1), drawn on ``device``
    in one call."""
    g = torch.Generator(device=device)
    g.manual_seed(torch_seed(seed, _RHS))
    return torch.rand((int(rhs["pool"]), n), generator=g, dtype=dtype,
                      device=device)


def step_shift(shift: dict, k: int, pos: int) -> float:
    """sigma of call ``k`` at step ``pos`` of a run (any seed's)."""
    h = float(shift["h"])
    lo, hi = (float(v) for v in shift["dt_log10"])
    m, jitter = int(shift["levels"]), float(shift["jitter"])
    u = float(substream(_SHIFT, k).uniform(-0.5, 0.5)) * jitter
    return h * h / 10.0 ** (lo + (pos % m + 0.5 + u) * (hi - lo) / m)


class Reservoir:
    """A uniform sample of ``size`` calls of the window, drawn from the
    seed as the calls come, plus the last call."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self.rng = substream(seed, _SAMPLE)
        self.items: list = []
        self.seen = 0
        self.last = None

    def offer(self, item) -> None:
        self.last = item
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.size:
                self.items[j] = item
        self.seen += 1

    def sample(self) -> list:
        out = list(self.items)
        if self.last is not None and all(it is not self.last for it in out):
            out.append(self.last)
        return out


def probe_vector(n: int, seed: int, salt: int, device) -> torch.Tensor:
    """A float64 random vector for the output check's probes."""
    g = torch.Generator(device=device)
    g.manual_seed(torch_seed(seed, _PROBE) ^ (salt & 0xFFFF))
    return torch.rand(n, generator=g, dtype=torch.float64, device=device) \
        - 0.5


def pool_index(k: int, rhs: dict) -> int:
    return k % int(rhs["pool"])
