"""The port's checkpoints (`shadow_tpu_torch.utils.checkpoint`) against
the reference's (`shadow_tpu.utils.checkpoint`), on the CPU.

Two scenarios, each run once per package and shared through a
module-scoped fixture: PHOLD over UDP at 16 hosts with a 12-slot queue
under spill, and TGen over TCP at 3 pairs with 16 slots under spill,
checkpointed at 3.5 sim-s with events parked in the host reservoir. For
each:

- the checkpoint header and leaves that the two packages write from
  the same state are the same: paths (the reference's keystr, in its
  flatten order), shapes, dtypes (uint64 leaves as uint64), CRC32s and
  the reservoir's extra arrays;
- the reference's checkpoint resumes in the port, and the port's in the
  reference, to the reference's final leaves, leaf for leaf.

Besides: rotation, a corrupt newest generation skipped by `--resume
auto`'s search as the reference skips it, the emergency file, the
atomic write's retry, widening of a narrower integer leaf from an older
format, `transfer_state` equal to the reference's, and the parts that
wait for later slices raising.
"""

import contextlib
import errno
import json

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from shadow_tpu import config as jconfig
from shadow_tpu import sim as jsim
from shadow_tpu.utils import checkpoint as jckpt
from shadow_tpu_torch import config as tconfig
from shadow_tpu_torch import convert
from shadow_tpu_torch import examples as texamples
from shadow_tpu_torch import sim as tsim
from shadow_tpu_torch.utils import checkpoint as tckpt
from test_torch_phold import assert_leaves_equal, jax_leaves

SECOND = 1_000_000_000

# name: (config text, build keywords, checkpoint time, end time)
SCENARIOS = {
    "phold_udp": (texamples.phold_example(16, 12, stoptime=2),
                  dict(seed=4, capacity=12), 1_500_000_000, 2 * SECOND),
    # tests/test_torch_pressure.py's TCP spill case, whose reference
    # programs the compile cache may already hold
    "tgen_tcp": (chip_smoke.tgen_config(3).replace(
        f'stoptime="{chip_smoke.TGEN_STOP_S}"', 'stoptime="6"'),
        dict(seed=chip_smoke.TGEN_SEED, n_sockets=chip_smoke.TGEN_SOCKETS,
             capacity=16), 3_500_000_000, 4_500_000_000),
}


@contextlib.contextmanager
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def header(path) -> dict:
    with np.load(path) as data:
        return json.loads(bytes(data["__header__"]).decode())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per scenario: both packages run to the checkpoint time, write a
    checkpoint (with the reservoir as extras) and run on to the end; the
    reference's final leaves; the built Simulations, for the resumes."""
    out = {}
    for name, (text, kw, mid, end) in SCENARIOS.items():
        d = tmp_path_factory.mktemp(name)
        js = jsim.build_simulation(jconfig.parse_config(text),
                                   overflow="spill", **kw)
        jmid = js.run(mid)
        jckpt.save_checkpoint(str(d / "j.npz"), jmid, meta={"t": mid},
                              extra=js.pressure.serialize())
        jfinal = jax_leaves(js.run(end, state=jmid))
        with one_thread():
            ts = tsim.build_simulation(tconfig.parse_config(text),
                                       overflow="spill", device="cpu", **kw)
            tmid = ts.run(mid)
            tckpt.save_checkpoint(str(d / "t.npz"), tmid, meta={"t": mid},
                                  extra=ts.pressure.serialize())
            tfinal = convert.engine_state_to_numpy(ts.run(end, state=tmid))
        out[name] = dict(dir=d, js=js, ts=ts, end=end, jfinal=jfinal,
                         tfinal=tfinal, tmid=tmid)
    return out


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_header_and_leaves_match_reference(runs, name):
    r = runs[name]
    hj, ht = header(r["dir"] / "j.npz"), header(r["dir"] / "t.npz")
    assert ht == hj
    assert ht["format_version"] == 7 and ht["xchg_empty"] is True
    assert ".queues.spill.pay" in ht["paths"]
    assert_leaves_equal(r["jfinal"], r["tfinal"])
    ej = jckpt.read_extra(str(r["dir"] / "j.npz"))
    et = tckpt.read_extra(str(r["dir"] / "t.npz"))
    assert ej.keys() == et.keys()
    for k in ej:
        np.testing.assert_array_equal(ej[k], et[k], err_msg=k)
        assert ej[k].dtype == et[k].dtype, k
    if name == "tgen_tcp":
        # the reservoir holds events at the write, and u64 leaves stay u64
        assert et["reservoir_time"].size > 0
        i = ht["paths"].index(".hosts.net.tcb.ooo")
        assert ht["dtypes"][i] == "uint64"
    assert tckpt.verify_checkpoint(str(r["dir"] / "j.npz")) == {
        "t": SCENARIOS[name][2]}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_reference_checkpoint_resumes_in_the_port(runs, name):
    r = runs[name]
    path = str(r["dir"] / "j.npz")
    ts = r["ts"]
    with one_thread():
        st, meta = tckpt.load_checkpoint(path, ts.state0)
        ts.pressure.restore(tckpt.read_extra(path))
        got = convert.engine_state_to_numpy(ts.run(r["end"], state=st))
    assert meta == {"t": SCENARIOS[name][2]}
    assert_leaves_equal(r["jfinal"], got)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_port_checkpoint_resumes_in_the_reference(runs, name):
    r = runs[name]
    path = str(r["dir"] / "t.npz")
    js = r["js"]
    st, meta = jckpt.load_checkpoint(path, js.state0)
    js.pressure.restore(jckpt.read_extra(path))
    assert meta == {"t": SCENARIOS[name][2]}
    assert_leaves_equal(r["jfinal"], jax_leaves(js.run(r["end"], state=st)))


def test_rotation_and_corrupt_generation_skipped(runs, tmp_path,
                                                 monkeypatch):
    st = runs["phold_udp"]["tmid"]
    path = str(tmp_path / "run.ckpt.npz")
    for i in range(4):
        tckpt.save_checkpoint(path, st, meta={"gen": i}, keep=3)
    gens = tckpt.checkpoint_generations(path)
    assert gens == [path, path + ".1", path + ".2"]
    assert [tckpt.read_header_info(p)["meta"]["gen"] for p in gens] == [
        3, 2, 1]
    assert gens == jckpt.checkpoint_generations(path)
    # truncate the newest generation: both packages skip it
    with open(path, "r+b") as f:
        f.truncate(f.seek(0, 2) // 2)
    for mod in (tckpt, jckpt):
        chosen, meta, skipped = mod.find_resume_checkpoint(path)
        assert chosen == path + ".1" and meta == {"gen": 2}
        assert [p for p, _ in skipped] == [path]
    # the crash-time file wins while it is the newest
    tckpt.save_checkpoint(path + ".emergency", st, meta={"gen": "e"})
    assert tckpt.find_resume_checkpoint(path)[0] == path + ".emergency"
    assert tckpt.find_resume_checkpoint(str(tmp_path / "none")) is None
    # a transient EINTR during the write is retried
    calls = []
    savez = tckpt._savez

    def flaky(f, **arrs):
        calls.append(1)
        if len(calls) == 1:
            raise OSError(errno.EINTR, "interrupted")
        return savez(f, **arrs)

    monkeypatch.setattr(tckpt, "_savez", flaky)
    monkeypatch.setattr(tckpt, "_io_sleep", lambda s: None)
    tckpt.save_checkpoint(str(tmp_path / "retry.npz"), st, meta={"r": 1})
    assert len(calls) == 2
    assert tckpt.verify_checkpoint(str(tmp_path / "retry.npz")) == {"r": 1}


def test_older_formats_widen_and_mismatches_refuse(runs, tmp_path):
    """A v4 file whose queue drops are i32 loads widened to i64; a tree
    or version the template does not take is refused by name."""
    r = runs["phold_udp"]
    src = r["dir"] / "t.npz"
    with np.load(src) as data:
        arrs = {k: data[k] for k in data.files}
    h = header(src)
    i = h["paths"].index(".queues.drops")
    arrs[f"leaf_{i}"] = arrs[f"leaf_{i}"].astype(np.int32)
    h.update(format_version=4, extra={})
    h["dtypes"][i] = "int32"
    h["crc32"][i] = tckpt._crc(arrs[f"leaf_{i}"])
    arrs = {k: v for k, v in arrs.items() if not k.startswith("extra_")}
    arrs["__header__"] = np.frombuffer(json.dumps(h).encode(), np.uint8)
    old = tmp_path / "v4.npz"
    np.savez(old, **arrs)
    st, _ = tckpt.load_checkpoint(str(old), r["ts"].state0)
    assert st.queues.drops.dtype == torch.int64
    assert tckpt.read_extra(str(old)) == {}
    h["format_version"] = 2
    arrs["__header__"] = np.frombuffer(json.dumps(h).encode(), np.uint8)
    np.savez(tmp_path / "v2.npz", **arrs)
    with pytest.raises(ValueError, match="format 2"):
        tckpt.load_checkpoint(str(tmp_path / "v2.npz"), r["ts"].state0)
    with pytest.raises(ValueError, match="leaves"):
        tckpt.load_checkpoint(str(src), runs["tgen_tcp"]["ts"].state0)
    (tmp_path / "junk.npz").write_bytes(b"not a checkpoint")
    with pytest.raises(ValueError, match="truncated or corrupt"):
        tckpt.verify_checkpoint(str(tmp_path / "junk.npz"))


def test_spill_ring_crosses_to_a_build_without_one(runs, tmp_path):
    """reshard=True loads a spill-mode checkpoint onto a drop-mode build
    when the ring parked nothing (the reference's rule)."""
    text, kw, mid, _ = SCENARIOS["phold_udp"]
    with one_thread():
        ts = tsim.build_simulation(tconfig.parse_config(text), device="cpu",
                                   **kw)
        st, _ = tckpt.load_checkpoint(str(runs["phold_udp"]["dir"] / "t.npz"),
                                      ts.state0, reshard=True)
    assert st.queues.spill is None and int(st.now) == mid
    with pytest.raises(ValueError, match="56 leaves, template has 49"):
        tckpt.load_checkpoint(str(runs["phold_udp"]["dir"] / "t.npz"),
                              ts.state0)


def test_transfer_state_matches_reference(runs):
    """The grow re-template: a capacity-12 state carried into a
    capacity-24 build, in both packages."""
    text, kw, mid, _ = SCENARIOS["phold_udp"]
    r = runs["phold_udp"]
    big = dict(kw, capacity=24)
    js = jsim.build_simulation(jconfig.parse_config(text), overflow="spill",
                               **big)
    jst, _ = jckpt.load_checkpoint(str(r["dir"] / "j.npz"), r["js"].state0)
    want = jax_leaves(jckpt.transfer_state(jst, js.state0))
    with one_thread():
        ts = tsim.build_simulation(tconfig.parse_config(text),
                                   overflow="spill", device="cpu", **big)
        got = convert.engine_state_to_numpy(
            tckpt.transfer_state(r["tmid"], ts.state0))
    assert_leaves_equal(want, got)
    assert got["queues.time"].shape[1] == 24
    with pytest.raises(ValueError, match="cannot shrink"):
        tckpt.transfer_state(ts.state0, r["ts"].state0)


def test_unported_parts_raise(runs, tmp_path):
    st = runs["phold_udp"]["tmid"]
    # the serving plane's manifest is ported: a state written with one
    # reads back in both packages, manifest and leaves
    man = {"version": 1, "rids": ["r000000"], "beats_done": 2}
    tckpt.save_checkpoint(str(tmp_path / "s.npz"), st,
                          meta={"plane": "serve"}, serve_manifest=man)
    for mod in (tckpt, jckpt):
        assert mod.read_header_info(str(tmp_path / "s.npz"))["serve"] == man
    back, meta = tckpt.load_checkpoint(str(tmp_path / "s.npz"), st)
    assert meta == {"plane": "serve"}
    assert_leaves_equal(convert.engine_state_to_numpy(st),
                        convert.engine_state_to_numpy(back))
    jst, _ = jckpt.load_checkpoint(str(tmp_path / "s.npz"),
                                   runs["phold_udp"]["js"].state0)
    assert_leaves_equal(jax_leaves(jst), convert.engine_state_to_numpy(st))
    # shard sets are ported (tests/test_torch_elastic.py): a torn set
    # next to the path is reported, never read
    assert tckpt.shard_member_path("p", 0, 2) == "p.shard0of2"
    (tmp_path / "p.npz.shard0of2").write_bytes(b"")
    tckpt.save_checkpoint(str(tmp_path / "p.npz"), st)
    chosen, _, skipped = tckpt.find_resume_checkpoint(str(tmp_path / "p.npz"))
    assert chosen == str(tmp_path / "p.npz")
    assert "incomplete shard set: 1 of 2" in skipped[0][1]
    assert convert.keystr("hosts.app.subs.0.gid") == ".hosts.app.subs[0].gid"
    assert convert.key_of(".hosts.app.subs[0].gid") == "hosts.app.subs.0.gid"
    assert jax.tree_util.keystr((jax.tree_util.GetAttrKey("a"),
                                 jax.tree_util.SequenceKey(0))) == ".a[0]"
