"""The traffic generator: a mix sets only keys that code reads, and each
resetup step's operator is its own, in its step's bin."""

import json

import pytest
from conftest import BENCH
from harness import spec, traffic


def mix(name):
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["rhs_stream", "resetup_stream"])
def test_each_mix_sets_exactly_what_its_kind_reads(name):
    m = mix(name)
    keys = spec.kind(m["kind"]).KEYS
    traffic.validate(m, keys)
    with pytest.raises(ValueError):
        traffic.validate(dict(m, callers=4), keys)
    group = next(iter(keys))
    with pytest.raises(ValueError):
        traffic.validate(dict(m, **{group: dict(m[group], low=0.5)}), keys)
    with pytest.raises(ValueError):
        traffic.validate({k: v for k, v in m.items() if k != "sample"}, keys)


def test_resetup_shifts_are_distinct_and_keep_their_bins():
    import math

    s = mix("resetup_stream")["shift"]
    m, (lo, hi) = s["levels"], s["dt_log10"]
    # call k at step pos: the warm-up calls take steps 0, 1, the window
    # starts again at step 0
    sig = [traffic.step_shift(s, k, pos)
           for k, pos in [(0, 0), (1, 1)] + [(2 + i, i) for i in range(40)]]
    assert len(set(sig)) == len(sig)
    for k, v in enumerate(sig):
        pos = k if k < 2 else k - 2
        x = (math.log10(s["h"] ** 2 / v) - lo) / (hi - lo) * m - pos % m
        assert 0.5 - s["jitter"] / 2 <= x <= 0.5 + s["jitter"] / 2
