"""The port's closed-loop load harness
(``distributed_tensorflow_example_tpu_torch/experiments/serving_load.py``)
on the CPU: ``--smoke`` runs every leg of the reference's smoke (slab on and
off, paged cold and shared, chunked, overload, the SLO report, int8, the
thread sanitizer, chaos, spec, flight recorder off, SLO sampler on and the
2-replica router leg) and must end ``"ok": true`` with every check true; the
flag combinations the reference refuses are refused; the fleet leg with
hedging serves the single-replica bytes."""

import json

import pytest
import torch

from distributed_tensorflow_example_tpu_torch.experiments import \
    serving_load as sl

# one intra-op thread per test process: the suite runs in parallel
# workers that share the machine's cores
torch.set_num_threads(1)

MODES = {"scheduler_on", "scheduler_off", "paged_cold", "paged_shared",
         "shared_off", "chunked_on", "overload", "slo_report", "int8_on",
         "tsan_on", "chaos_on", "spec_off", "spec_on", "flightrec_off",
         "slo_on", "router_on"}


@pytest.fixture(scope="module")
def smoke():
    """The smoke's rows by mode and its summary, run once."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = sl.main(["--smoke", "--device", "cpu"])
    rows = [json.loads(ln) for ln in buf.getvalue().splitlines()
            if ln.startswith("{")]
    summary = [r for r in rows if r.get("summary")]
    return rc, {r["mode"]: r for r in rows if "mode" in r}, summary


def test_smoke_ends_ok_with_every_check_true(smoke):
    rc, modes, summary = smoke
    assert summary, "no summary line"
    s = summary[0]
    checks = {k: v for k, v in s.items() if isinstance(v, bool)}
    assert {k for k, v in checks.items() if v is not True} == set(), s
    assert rc == 0 and s["ok"] is True
    assert s["greedy_parity"] is True
    assert set(modes) == MODES
    assert all(not r["errors"] for r in modes.values())
    # the reference's smoke lists these; every one is here and true
    for name in ("paged_vs_slab_parity", "shared_vs_cold_admission_parity",
                 "shared_prefills_below_cold", "scheduler_trace_valid",
                 "int8_drift_within_bound", "int8_admits_more_than_bf16",
                 "tsan_parity_with_unarmed", "tsan_zero_dispatch_delta",
                 "tsan_catches_cross_thread",
                 "chaos_parity_with_fault_disabled",
                 "chaos_dispatch_count_parity",
                 "chaos_exactly_one_redispatch",
                 "chaos_zero_failed_requests", "spec_parity_with_off",
                 "spec_accept_rate_positive",
                 "spec_verify_dispatches_below_emitted_tokens",
                 "spec_emitted_per_verify_dispatch_above_one",
                 "spec_total_dispatch_win",
                 "spec_off_zero_verify_dispatches",
                 "router_parity_with_single_replica",
                 "router_zero_client_failures",
                 "router_counts_every_request",
                 "router_registry_p95_positive",
                 "flightrec_off_parity_with_on",
                 "flightrec_off_dispatch_parity",
                 "no_saturated_histograms", "chunked_parity_with_off",
                 "chunked_prefill_dispatches", "chunk_noop_when_off",
                 "overload_interactive_zero_failures",
                 "overload_interactive_no_deadline_misses",
                 "overload_sheds_with_retry_after",
                 "overload_shed_accounting", "overload_recovers_healthy",
                 "overload_p95_within_deadline", "slo_report_reconciles",
                 "slo_report_interactive_all_served",
                 "slo_report_sheds_best_effort",
                 "slo_burn_exactly_one_bundle", "slo_burn_rate_limited",
                 "slo_burn_bundle_matches_metrics",
                 "slo_burn_advisory_on_healthz",
                 "slo_goodput_positive_and_bounded",
                 "slo_on_parity_with_plain", "slo_on_dispatch_parity",
                 "chunk_stall_parity",
                 "chunk_stall_bounded_below_monolithic",
                 "chunk_stall_p95_drops"):
        assert checks.get(name) is True, name


def test_smoke_rows_carry_the_references_story(smoke):
    _, modes, summary = smoke
    s = summary[0]
    on = modes["scheduler_on"]
    assert on["requests"] == 4 and on["tokens_per_s"] > 0
    assert on["latency_p95_ms"] > 0
    assert on["decode_steps"] <= on["requests"] * 4   # smoke max_new=4
    assert (modes["paged_shared"]["prefills"]
            < modes["paged_cold"]["prefills"])
    assert modes["paged_shared"]["prefix_cache_hits"] > 0
    assert modes["paged_shared"]["prefill_tokens_saved"] > 0
    i8 = modes["int8_on"]
    assert i8["int8_agreement"] >= sl.INT8_MIN_AGREEMENT
    assert i8["capacity_int8"] > i8["capacity_bf16"]
    assert i8["registry"]["serving_bytes_resident_peak"] > 0
    assert modes["tsan_on"]["tsan_violation_caught"] is True
    assert modes["chaos_on"]["registry"]["serving_redispatches_total"] == 1
    spec = modes["spec_on"]
    assert spec["accept_rate"] > 0 and spec["spec_accepted"] > 0
    assert (spec["spec_emitted"] / spec["verify_steps"]) > 1.0
    assert (spec["decode_steps"] + spec["verify_steps"]
            < modes["spec_off"]["decode_steps"])
    router = modes["router_on"]
    assert router["replicas"] == 2
    assert router["router_requests"] == router["requests"] == 4
    assert sum(router["served_by"].values()) == 4
    assert router["fleet_registry_p95_ms"] > 0
    assert router["saturated_histograms"] == []
    chunked = modes["chunked_on"]
    assert chunked["registry"]["serving_prefill_chunks_total"] > 0
    assert chunked["registry"]["serving_prefills_total"] == 0
    over = modes["overload"]
    assert over["shed_429"] > 0 and over["missing_retry_after"] == 0
    assert over["deadline_expired"] == 0
    assert s["chunk_stall_on_ms"] < s["chunk_stall_off_ms"]
    rep = modes["slo_report"]
    assert rep["reconcile_diff"] == []
    assert rep["attainment_interactive"] == 1.0
    assert rep["attainment_best_effort"] is not None
    assert rep["attainment_best_effort"] < 1.0
    assert rep["goodput_tps"] <= rep["throughput_tps"]
    assert rep["healthz_breaching"] == ["best_effort:hit_rate"]


@pytest.mark.parametrize("argv,frag", [
    (["--smoke", "--thread_sanitizer"], "vacuous"),
    (["--smoke", "--router", "2"], "own 2-replica router leg"),
    (["--smoke", "--weight_quant", "int8"], "own fully quantized"),
    (["--smoke", "--paged", "--spec_tokens", "4"], "own spec_on/spec_off"),
    (["--kv_cache_dtype", "int8"], "add --paged"),
    (["--router", "2", "--weight_quant", "int8"], "LOSSY"),
    (["--router", "-1"], "replica count >= 0"),
    (["--spec_tokens", "4"], "add --paged"),
    (["--paged", "--spec_tokens", "1"], "must be >= 2"),
])
def test_flag_combinations_refused(capsys, argv, frag):
    with pytest.raises(SystemExit):
        sl.main(argv + ["--device", "cpu"])
    assert frag in capsys.readouterr().err


def test_router_mode_with_hedging_serves_single_replica_bytes(tmp_path):
    """The bench row's fleet leg, small: ``run_router_mode(replicas=2,
    hedge_after_ms=200)`` over the matrix the single replica served,
    byte-identical, every request counted once at the router."""
    sl._RUN["device"] = "cpu"
    d = str(tmp_path / "paged")
    vocab = sl.build_export(d, prompt_len=8, max_new=6, slots=4, seed=0,
                            paged=True, block_size=4)
    matrix = sl.make_requests(4, 2, prompt_len=8, max_new=6, vocab=vocab,
                              seed=0)
    one = sl.run_mode(d, matrix, scheduler="on", prompt_len=8)
    fleet = sl.run_router_mode(d, matrix, replicas=2, hedge_after_ms=200)
    assert not one["errors"] and not fleet["errors"]
    assert fleet["_gens"] == one["_gens"]
    assert fleet["router_requests"] == fleet["requests"] == 8
    assert sum(fleet["served_by"].values()) == 8
    assert fleet["router_hedge_wins"] <= fleet["router_hedges"]
    # a hedge fires when a request outlives 200 ms, which load decides;
    # its copy is prefilled only if admitted before its cancel. So the
    # exact count is the replicas' admissions: each request once, plus
    # each hedged or retried copy admitted (none when none fired)
    extra = fleet["admissions"] - 8
    assert 0 <= extra <= fleet["router_hedges"] + fleet["router_retries"]
    assert fleet["decode_steps"] > 0 and fleet["prefills"] == 8 + extra
