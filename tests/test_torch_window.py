"""Per-window widths (`--window N|auto`) in shadow_tpu_torch against
shadow_tpu, on the CPU.

- `runtime/adaptive.py`'s WindowController: the cases of
  tests/test_drain_pipeline.py and a seeded sequence of probes give the
  reference's widths and history;
- `Simulation.step_window(window_ns=)` and `dispatch(window_ns=)` (one
  window per call) driven through one sequence of widths, narrower and
  wider than the lookahead, end in the reference's leaves on PHOLD over
  UDP and on TGen over TCP;
- the command line under `--window <2 x lookahead>` and `--window auto`
  (with `--overflow strict`) prints the reference's stripped stdout and
  writes its final state, and each refusal (spill or grow, a width
  narrower than the lookahead, a malformed width) exits 2 with the
  reference's message.

Every comparison is exact, dtypes included.
"""

import numpy as np
import pytest

import chip_smoke
from shadow_tpu import config as jconfig
from shadow_tpu import sim as jsim
from shadow_tpu.runtime.adaptive import WindowController as JController
from shadow_tpu_torch import config as tconfig
from shadow_tpu_torch import convert
from shadow_tpu_torch import examples as texamples
from shadow_tpu_torch import sim as tsim
from shadow_tpu_torch.runtime.adaptive import WindowController as TController
from test_pcap import _cfg
from test_torch_pcap_cli import run_cli
from test_torch_phold import assert_leaves_equal, jax_leaves
from test_torch_tcp import one_torch_thread  # noqa: F401 (autouse)

MS = 1_000_000
BASE = 50 * MS
CONTROLLERS = {"jax": JController, "torch": TController}

# (constructor keywords, probes (executed_cum, drops_cum, fill)), the
# cases of tests/test_drain_pipeline.py
CASES = {
    "widen_and_cap": (dict(n_hosts=64, max_mult=8),
                      [(i * 4, 0, 0.01) for i in range(1, 8)]),
    "narrow": (dict(n_hosts=4, max_mult=64),
               [(2, 0, 0.01), (4, 0, 0.01), (6, 5, 0.01), (8, 5, 0.9),
                (10, 5, 0.9)]),
    "busy_hold": (dict(n_hosts=4), [(100 * i, 0, 0.3) for i in range(1, 5)]),
    "mixed": (dict(n_hosts=16),
              [(30 * i, i // 3, 0.1 * (i % 5)) for i in range(1, 20)]),
}


def seeded_probes(seed=11, n=200):
    """Cumulative executed and drop counts and f32 fills around the
    thresholds (0.25, 0.5 and their f32 neighbours)."""
    rng = np.random.default_rng(seed)
    ex = np.cumsum(rng.integers(0, 40, n))
    dr = np.cumsum(rng.random(n) < 0.1)
    edge = np.float32([0.25, 0.5])
    fills = np.concatenate([rng.random(n - 6).astype(np.float32),
                            edge, np.nextafter(edge, 0),
                            np.nextafter(edge, 1)])
    return [(int(e), int(d), float(f)) for e, d, f in zip(ex, dr, fills)]


CASES["seeded"] = (dict(n_hosts=24, max_mult=16), seeded_probes())


@pytest.mark.parametrize("case", list(CASES))
def test_window_controller_matches_reference(case):
    kw, probes = CASES[case]
    got = {}
    for pkg, cls in CONTROLLERS.items():
        ctl = cls(BASE, **kw)
        widths = [ctl.update(*p) for p in probes]
        got[pkg] = (widths, ctl.history, ctl.window_ns)
    assert got["torch"] == got["jax"]
    widths = got["torch"][0]
    if case == "widen_and_cap":
        assert widths[:2] == [2 * BASE, 4 * BASE] and widths[-1] == 8 * BASE
    if case == "narrow":
        assert widths == [2 * BASE, 4 * BASE, 2 * BASE, BASE, BASE]
    if case == "busy_hold":
        assert widths == [BASE] * 4


def test_window_controller_rejects_a_zero_base():
    for cls in CONTROLLERS.values():
        with pytest.raises(ValueError, match=">= 1 ns"):
            cls(0, n_hosts=4)


# -- Simulation.step_window / dispatch with a width ------------------------
# widths cycle through these multiples of the lookahead (and one odd
# width in ns), narrower and wider than it
WIDTHS = (2.0, 1.0, 4.0, 0.5, 3.0, 7_777_777)


def width_at(i: int, lookahead: int) -> int:
    w = WIDTHS[i % len(WIDTHS)]
    return int(w * lookahead) if isinstance(w, float) else w


def stepped(sim, stop: int, via: str):
    """sim run window by window to `stop` through the width sequence;
    (final state, windows)."""
    st, i = None, 0
    la = sim.engine.cfg.lookahead
    while True:
        w = width_at(i, la)
        if via == "dispatch":
            st = sim.dispatch(stop, sim.state0 if st is None else st,
                              window_ns=w)
        else:
            st = sim.step_window(st, stop, window_ns=w)
        i += 1
        if int(np.asarray(st.now)) >= stop:
            return st, i


SIMS = {
    "phold_udp": (lambda tmp: texamples.phold_example(16, 3, stoptime=2),
                  dict(seed=5)),
    "tgen_tcp": (lambda tmp: _cfg(tmp).replace(' logpcap="true"', "")
                 .replace(f' pcapdir="{tmp}"', "")
                 .replace('stoptime="30"', 'stoptime="4"'),
                 dict(seed=4, burst_rx=False)),
}


@pytest.mark.parametrize("name", list(SIMS))
def test_step_window_with_widths_matches_reference(name, tmp_path):
    make, kw = SIMS[name]
    text = make(tmp_path)
    js = jsim.build_simulation(jconfig.parse_config(text), **kw)
    ts = tsim.build_simulation(tconfig.parse_config(text), device="cpu",
                               **kw)
    stop = js.stop_ns
    jst, jn = stepped(js, stop, "step_window")
    lj = jax_leaves(jst)
    for via in ("step_window", "dispatch"):
        tst, tn = stepped(ts, stop, via)
        assert tn == jn
        assert_leaves_equal(lj, convert.engine_state_to_numpy(tst))
    assert lj["stats.n_executed"].sum() > 0
    # a width is not the lookahead's run: cross-host arrivals move to the
    # wider windows' ends
    plain = convert.engine_state_to_numpy(ts.run())
    assert convert.leaves_digest(plain) != convert.leaves_digest(lj)


# -- the command line -------------------------------------------------------
PHOLD = texamples.phold_example(16, 3, stoptime=2)
ARGV = ["phold.xml", "--seed", "8", "--heartbeat-frequency", "0.5",
        "--overflow", "strict", "--checkpoint-interval", "2",
        "--checkpoint-path", "w.ckpt.npz"]


@pytest.mark.parametrize("width", ["100", "auto"])
def test_cli_window_matches_reference(width, tmp_path):
    got = {pkg: run_cli(pkg, tmp_path / pkg, ARGV + ["--window", width],
                        config=PHOLD)
           for pkg in ("jax", "torch")}
    j, t = got["jax"], got["torch"]
    assert j["rc"] == t["rc"] == 0
    assert t["stripped"] == j["stripped"]
    assert chip_smoke.checkpoint_digest(t["dir"] / "w.ckpt.npz") == \
        chip_smoke.checkpoint_digest(j["dir"] / "w.ckpt.npz")
    assert t["summary"]["events"] > 0
    # fewer windows than the lookahead's 50 ms would take
    assert t["summary"]["windows"] < 20


REFUSALS = {
    "spill": ["--window", "100"],
    "grow": ["--window", "auto", "--overflow", "grow"],
    "narrow": ["--window", "10", "--overflow", "drop"],
    "malformed": ["--window", "wide", "--overflow", "strict"],
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_cli_window_refusals_match_reference(name, tmp_path):
    argv = ["phold.xml", "--seed", "8"] + REFUSALS[name]
    got = {pkg: run_cli(pkg, tmp_path / pkg, argv, config=PHOLD)
           for pkg in ("jax", "torch")}
    assert got["torch"]["rc"] == got["jax"]["rc"] == 2
    last = {pkg: r["err"].strip().splitlines()[-1] for pkg, r in got.items()}
    assert last["torch"] == last["jax"]
    assert last["torch"].startswith("error: --window")
    assert got["torch"]["summary"] is None and got["torch"]["out"] == ""
