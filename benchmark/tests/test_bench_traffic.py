"""The seeded traffic repeats for a seed and differs between seeds."""

import numpy as np
import pytest

import bench_cpu  # noqa: F401  (the harness on sys.path)
from harness import spec as spec_mod
from harness.fields import lattice_coords
from harness.traffic import Traffic

SEEDS = (0, 7, 2**31 + 5, 2**33 + 1)


def _params(name):
    return spec_mod.traffic(name)


def test_a_seed_gives_the_same_inputs_and_another_seed_others():
    p = _params("solve")
    for seed in SEEDS:
        a, b = Traffic(p, seed), Traffic(p, seed)
        assert [a.input(k) for k in range(6)] == [b.input(k) for k in range(6)]
    firsts = {Traffic(p, s).input(0) for s in SEEDS}
    assert len(firsts) == len(SEEDS)
    t = Traffic(p, SEEDS[0])
    assert t.input(0) != t.input(1) != t.input(2)


def test_a_carried_state_has_no_input_and_the_seed_draws_only_the_sample():
    p = _params("steps")
    samples = []
    for seed in SEEDS:
        t = Traffic(p, seed)
        assert t.carried and t.input(0) is None and t.input(57) is None
        r = t.sampler()
        for k in range(2, 300):
            r.offer(k, k)
        samples.append(tuple(r.sample()))
    assert len(set(samples)) == len(SEEDS)


def test_a_traffic_file_names_its_state():
    with pytest.raises(ValueError):
        Traffic({**_params("steps"), "state": "episodes"}, 1)


def test_fields_keep_to_their_ranges_and_vanish_on_the_walls_less_the_base():
    p = _params("solve")
    field = Traffic(p, 3).input(4)
    assert len(field.terms) == p["terms"]
    for a, *k in field.terms:
        assert p["amplitude"][0] <= a <= p["amplitude"][1]
        assert all(p["frequency"][0] <= v <= p["frequency"][1] for v in k)
    values = field.on_lattice(lattice_coords(8)) - field.base
    for face in (values[0], values[-1], values[:, 0], values[:, -1],
                 values[:, :, 0], values[:, :, -1]):
        assert np.abs(face).max() < 1e-12 * max(1.0, np.abs(values).max())


def test_the_torch_field_is_the_numpy_field():
    import torch

    field = Traffic(_params("solve"), 9).input(2)
    c = lattice_coords(6)
    assert np.allclose(field.on_lattice_torch(c, torch.float64, "cpu").numpy(),
                       field.on_lattice(c), rtol=0, atol=1e-14)


@pytest.mark.parametrize("name", ["steps", "solve"])
def test_the_sample_of_requests_repeats_and_holds_the_last(name):
    p = _params(name)
    picks = []
    for _ in range(2):
        r = Traffic(p, 41).sampler()
        for k in range(30):
            r.offer(k, f"answer {k}")
        picks.append(r.sample())
    assert picks[0] == picks[1]
    assert len(picks[0]) == p["compare"] and 29 in picks[0]
    few = Traffic(p, 41).sampler()
    for k in range(2):
        few.offer(k, k)
    assert few.sample() == {0: 0, 1: 1}
