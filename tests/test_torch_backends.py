"""Port vs reference: exact GEMM designs, the backend API, pricing, and the
jax-free modules the port keeps its own copy of.

Integer results, cycle counts and prices must be EQUAL (tolerance 0 — the
pricing code is the same closed-form Python arithmetic on both sides);
sparsity statistics are float32 means and must be equal as well at these
sizes (every sum stays below 2^24).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import backends as ref_backends
from repro import configs as ref_configs
from repro.analysis import ranges as ref_ranges
from repro.configs import paper_gemm as ref_paper
from repro.core import accounting as ref_acct
from repro.core import gemm_sims as ref_sims
from repro.core import ppa as ref_ppa
from repro.core import sparsity as ref_sparsity
from repro.serving import scheduler as ref_sched
from repro.serving import traffic as ref_traffic
from repro_torch import backends as port_backends
from repro_torch import configs as port_configs
from repro_torch.analysis import ranges as port_ranges
from repro_torch.configs import paper_gemm as port_paper
from repro_torch.core import accounting as port_acct
from repro_torch.core import gemm_sims as port_sims
from repro_torch.core import ppa as port_ppa
from repro_torch.core import sparsity as port_sparsity
from repro_torch.serving import scheduler as port_sched
from repro_torch.serving import traffic as port_traffic

BITS = (2, 4, 8)
EXACT = ("bgemm", "tugemm", "tubgemm")


def _codes(rng, shape, bits):
    v = 2 ** (bits - 1) - 1
    return rng.integers(-v, v + 1, size=shape).astype(np.int8)


@pytest.mark.parametrize("design", EXACT)
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("shape", [(5, 7, 3), (16, 64, 48)])
def test_exact_designs_equal(design, bits, shape):
    m, k, n = shape
    rng = np.random.default_rng(bits * 100 + m)
    a, b = _codes(rng, (m, k), bits), _codes(rng, (k, n), bits)
    ref = ref_backends.resolve(design, bits=bits).execute(jnp.asarray(a), jnp.asarray(b))
    port = port_backends.resolve(design, bits=bits).execute(
        torch.from_numpy(a), torch.from_numpy(b))
    assert port.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(ref), port.numpy())
    fn = {"bgemm": port_sims.bgemm_exact, "tugemm": port_sims.tugemm_exact,
          "tubgemm": port_sims.tubgemm_exact}[design]
    np.testing.assert_array_equal(
        fn(torch.from_numpy(a), torch.from_numpy(b)).numpy(), np.asarray(ref))


@pytest.mark.parametrize("shared", [True, False])
def test_batched_execute_equal(shared):
    rng = np.random.default_rng(5)
    a = _codes(rng, (3, 4, 16), 4)
    b = _codes(rng, (16, 6) if shared else (3, 16, 6), 4)
    ref = ref_backends.resolve("tubgemm", bits=4).execute(jnp.asarray(a), jnp.asarray(b))
    port = port_backends.resolve("tubgemm", bits=4).execute(
        torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(np.asarray(ref), port.numpy())
    with pytest.raises(ValueError):
        port_backends.resolve("tubgemm", bits=4).execute(
            torch.zeros((1, 1, 1, 2), dtype=torch.int8),
            torch.zeros((2, 2), dtype=torch.int8))


@pytest.mark.parametrize("design", EXACT + ("ugemm",))
@pytest.mark.parametrize("bits", BITS)
def test_cycles_and_dyn_cycles_equal(design, bits):
    rb = ref_backends.resolve(design, bits=bits)
    pb = port_backends.resolve(design, bits=bits)
    assert (rb.name, rb.bits, rb.exact, rb.has_synthesis_data, rb.pricing_design) \
        == (pb.name, pb.bits, pb.exact, pb.has_synthesis_data, pb.pricing_design)
    for k in (1, 64, 4096):
        assert rb.cycles(k) == pb.cycles(k)
        assert ref_sims.wc_cycles(design, bits, k) == port_sims.wc_cycles(design, bits, k)
        assert rb.dyn_cycles(k) == pb.dyn_cycles(k)
        assert rb.dyn_cycles(k, bit_sparsity=0.37) == pb.dyn_cycles(k, bit_sparsity=0.37)
        assert ref_sims.dynamic_cycles_from_sparsity(design, bits, k, 0.25) \
            == port_sims.dynamic_cycles_from_sparsity(design, bits, k, 0.25)
    rng = np.random.default_rng(bits)
    operand = _codes(rng, (24, 5), bits)
    assert rb.dyn_cycles(operand=jnp.asarray(operand)) \
        == pb.dyn_cycles(operand=torch.from_numpy(operand))
    assert rb.dyn_cycles(operand=jnp.asarray(operand[:, 0])) \
        == pb.dyn_cycles(operand=torch.from_numpy(operand[:, 0]))
    with pytest.raises(ValueError):
        pb.dyn_cycles()
    with pytest.raises(ValueError):
        pb.dyn_cycles(4, bit_sparsity=0.1, operand=torch.from_numpy(operand))


@pytest.mark.parametrize("design", EXACT + ("ugemm",))
@pytest.mark.parametrize("bits", BITS)
def test_price_equal(design, bits):
    calls = [("layers/attn/wq", 3, 64, 64, 0.31, 2), ("lm_head", 3, 64, 512, 0.12, 1),
             ("layers/mlp/w_up", 17, 64, 192, 0.0, 2)]
    r = ref_acct.GemmWorkloadRecorder()
    p = port_acct.GemmWorkloadRecorder()
    for name, m, k, n, s, c in calls:
        r.record(name, m=m, k=k, n_out=n, bit_sparsity=s, count=c)
        p.record(name, m=m, k=k, n_out=n, bit_sparsity=s, count=c)
    for unit_n, units in ((64, 64), (128, 1)):
        rc = ref_backends.resolve(design, bits=bits).price(r, unit_n=unit_n, num_units=units)
        pc = port_backends.resolve(design, bits=bits).price(p, unit_n=unit_n, num_units=units)
        assert dataclasses.asdict(rc) == dataclasses.asdict(pc)
        assert rc.energy_per_mac_pj == pc.energy_per_mac_pj
        assert rc.sparsity_saving == pc.sparsity_saving


def test_resolve_and_registry():
    assert port_sims.DESIGNS == ref_sims.DESIGNS == ("ugemm", "tugemm", "tubgemm", "bgemm")
    assert port_backends.available() == ("ugemm", "tugemm", "tubgemm", "bgemm",
                                         "tugemm_cuda", "tubgemm_cuda",
                                         "ugemm_stochastic")
    be = port_backends.resolve("tubgemm", bits=4)
    assert port_backends.resolve(be) is be
    assert port_backends.resolve(be, bits=8).bits == 8
    assert port_backends.resolve("tubgemm", bits=4) == be
    for mirror, sibling in port_backends.KERNEL_SIBLINGS.items():
        mb = port_backends.resolve(mirror, bits=4)
        rb = ref_backends.resolve(sibling + "_pallas", bits=4)
        assert mb.pricing_design == rb.pricing_design == sibling
        assert mb.exact and not mb.has_synthesis_data
        assert mb.cycles(64) == rb.cycles(64)
    with pytest.raises(ValueError, match="unknown design"):
        port_backends.resolve("nope")
    with pytest.raises(ValueError):
        port_backends.resolve("tubgemm", bits=1)
    # uGEMM executes its stochastic multiplier: the reference's value on
    # the same codes (bit-exact at 4 bits)
    a = np.random.default_rng(1).integers(-7, 8, (3, 5)).astype(np.int8)
    b = np.random.default_rng(2).integers(-7, 8, (5, 4)).astype(np.int8)
    np.testing.assert_array_equal(
        port_backends.resolve("ugemm", bits=4).execute(
            torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(ref_backends.resolve("ugemm", bits=4).execute(
            jnp.asarray(a), jnp.asarray(b))))
    with port_sims.scoped_registry():
        port_sims.register_design("custom", lambda a, b, bits: a, lambda a, b, bits: (a, 0),
                                  lambda bits, k: 7)
        assert "custom" in port_sims.DESIGNS
        assert port_backends.resolve("custom").cycles(3) == 7
        with pytest.raises(ValueError):
            port_sims.register_design("custom", None, None, None)
    assert "custom" not in port_sims.DESIGNS
    snap = port_sims.registry_snapshot()
    port_sims.registry_restore(snap)
    assert port_sims.DESIGNS == ref_sims.DESIGNS


@pytest.mark.parametrize("design", EXACT)
@pytest.mark.parametrize("bits", BITS)
def test_envelope_guard_at_max_safe_k(design, bits):
    safe = port_ranges.max_safe_k(design, bits)
    assert safe == ref_ranges.max_safe_k(design, bits)
    port_ranges.assert_within_envelope(design, bits, safe)
    with pytest.raises(ValueError):
        port_ranges.assert_within_envelope(design, bits, safe + 1)
    be = port_backends.resolve(design, bits=bits)
    be._guard_envelope(safe)
    with pytest.raises(ValueError):
        be._guard_envelope(safe + 1)
    # the guard fires before any arithmetic: shapes alone decide
    with pytest.raises(ValueError):
        be.execute(torch.empty((1, safe + 1), dtype=torch.int8, device="meta"),
                   torch.empty((safe + 1, 1), dtype=torch.int8, device="meta"))


def test_bgemm_exact_at_int32_boundary():
    # K * vmax^2 right at the envelope edge for 8 bits, all-max operands
    k = port_ranges.max_safe_k("bgemm", 8)
    kk = min(k, 40000)
    a = torch.full((2, kk), 127, dtype=torch.int8)
    b = torch.full((kk, 3), -127, dtype=torch.int8)
    out = port_sims.bgemm_exact(a, b)
    assert out.dtype == torch.int32
    assert int(out[0, 0]) == -127 * 127 * kk
    for family in ("bgemm", "tugemm", "tubgemm", "ugemm"):
        for bits in BITS:
            assert port_ranges.accumulator_bound(family, bits, 4096).describe() == \
                ref_ranges.accumulator_bound(family, bits, 4096).describe()
    assert port_ranges.design_family("tubgemm_cuda") == "tubgemm"


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("shape", [(64, 64), (70, 33), (2, 40, 64), (96,)])
def test_sparsity_profile_equal(bits, shape):
    rng = np.random.default_rng(bits + len(shape))
    x = (rng.standard_normal(shape) * rng.random(shape)).astype(np.float32)
    ref = ref_sparsity.profile_tensor(jnp.asarray(x), bits=bits)
    port = port_sparsity.profile_tensor(torch.from_numpy(x), bits=bits)
    assert dataclasses.asdict(ref) == dataclasses.asdict(port)
    q = _codes(rng, shape, bits)
    refq = ref_sparsity.profile_tensor(jnp.asarray(q), bits=bits, pre_quantized=True)
    portq = port_sparsity.profile_tensor(torch.from_numpy(q), bits=bits, pre_quantized=True)
    assert dataclasses.asdict(refq) == dataclasses.asdict(portq)
    assert float(ref_sparsity.word_sparsity(jnp.asarray(q))) == port_sparsity.word_sparsity(torch.from_numpy(q))
    assert float(ref_sparsity.bit_sparsity_elementwise(jnp.asarray(q), bits)) \
        == port_sparsity.bit_sparsity_elementwise(torch.from_numpy(q), bits)
    assert float(ref_sparsity.bit_sparsity_blockmax(jnp.asarray(q), bits)) \
        == port_sparsity.bit_sparsity_blockmax(torch.from_numpy(q), bits)
    assert portq.dynamic_fraction() == refq.dynamic_fraction()


def test_sparsity_profile_chunked_walk_matches_single_pass(monkeypatch):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((256, 48)).astype(np.float32))
    whole = port_sparsity.profile_tensor(x, bits=4)
    monkeypatch.setattr(port_sparsity, "_PROFILE_CHUNK_ELEMS", 48 * 32)
    assert port_sparsity.profile_tensor(x, bits=4) == whole


def test_copied_modules_equal():
    for arch in port_configs.ARCH_IDS:
        for fn in ("get_config", "get_smoke_config"):
            assert dataclasses.asdict(getattr(ref_configs, fn)(arch)) \
                == dataclasses.asdict(getattr(port_configs, fn)(arch))
    # the reference's registry in its order
    assert port_configs.ARCH_IDS == ref_configs.ARCH_IDS
    assert ref_paper.DESIGNS == port_paper.DESIGNS
    for grid in ("table_grid", "tpu_grid"):
        assert [dataclasses.astuple(c) for c in getattr(ref_paper, grid)()] \
            == [dataclasses.astuple(c) for c in getattr(port_paper, grid)()]
    for design in ref_paper.DESIGNS:
        for bits in BITS:
            for n in (16, 32, 64, 128):
                for fn in ("area_um2", "power_mw", "energy_nj", "adp_mm2_ns"):
                    assert getattr(ref_ppa, fn)(design, bits, n) \
                        == getattr(port_ppa, fn)(design, bits, n)
                assert ref_ppa.latency_ns(design, bits, n) \
                    == port_ppa.latency_ns(design, bits, n)
                assert ref_ppa.dynamic_energy_nj(design, bits, n, 0.3) \
                    == port_ppa.dynamic_energy_nj(design, bits, n, 0.3)
            rd = ref_ppa.DLAModel(design=design, bits=bits, n=64, num_units=8)
            pd = port_ppa.DLAModel(design=design, bits=bits, n=64, num_units=8)
            assert rd.matmul_latency_ns(5, 300, 200, 0.3) == pd.matmul_latency_ns(5, 300, 200, 0.3)
            assert rd.matmul_energy_nj(5, 300, 200, 0.3) == pd.matmul_energy_nj(5, 300, 200, 0.3)
    assert ref_ppa.CLOCK_PERIOD_NS == port_ppa.CLOCK_PERIOD_NS


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_traffic_and_scheduler_equal(seed):
    kw = dict(num_requests=20, arrival_rate=0.7, seed=seed)
    rt = ref_traffic.generate_trace(ref_traffic.TrafficConfig(**kw))
    pt = port_traffic.generate_trace(port_traffic.TrafficConfig(**kw))
    assert [dataclasses.astuple(r) for r in rt] == [dataclasses.astuple(r) for r in pt]

    class Cache:  # the schedulers only ask for the free-page budget
        class allocator:
            num_free = 9

        @staticmethod
        def pages_needed(total_len):
            return -(-total_len // 8)

    for name in ("continuous", "static"):
        rs = ref_sched.make_scheduler(name, 4)
        ps = port_sched.make_scheduler(name, 4)
        assert rs.name == ps.name and rs.max_batch == ps.max_batch
        rw = [ref_sched.Request(spec=r) for r in rt]
        pw = [port_sched.Request(spec=r) for r in pt]
        for step in (0, 3, 9):
            for running in (0, 2, 4):
                ra = rs.admissions(step, rw, running, Cache())
                pa = ps.admissions(step, pw, running, Cache())
                assert [r.spec.req_id for r in ra] == [r.spec.req_id for r in pa]
