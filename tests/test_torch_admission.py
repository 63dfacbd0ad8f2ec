"""PyTorch port: admission control (``mmlspark_tpu_torch/serving/
admission.py``) and the engine's dynamic ``Retry-After``, against the JAX
package, on the CPU.

``tests/test_zoo.py``'s ``TestAdmission`` and ``tests/test_adaptive.py``'s
``TestDynamicRetryAfter`` run over port engines (``port=0``): request
identity from headers, quota and priority verdicts, the 429 that a fleet
does not fail over, routing before admission (an unknown model spends no
quota), a low tier shed with 503 under pressure, the pressure signal
counting the source backlog, and the backlog / drain-rate estimate with
its clamp and rate gate.

Held against the JAX package: the same verdict sequence and ``stats()``
for the same scripted ``decide`` calls, and the same identity for the
same headers (equal).
"""

import json
import urllib.error
import urllib.request

import pytest

from mmlspark_tpu.serving.admission import (
    AdmissionController as JAdmissionController,
    TenantQuota as JTenantQuota, request_identity as jrequest_identity,
)

from mmlspark_tpu_torch.serving import (
    AdmissionController, HTTPSource, ModelZoo, ServingEngine,
    ServingFleet, TenantQuota,
)
from mmlspark_tpu_torch.serving.admission import request_identity
from mmlspark_tpu_torch.stages.basic import Lambda


def echo_stage(tag):
    def handle(table):
        replies = []
        for r in table["request"]:
            row = json.loads(r["entity"].decode()) if r.get("entity") \
                else {}
            replies.append({"served_by": tag, "x": row.get("x")})
        return table.with_column("reply", replies)
    return Lambda.apply(handle)


def fresh_zoo(n_models=1):
    zoo = ModelZoo(memory_probe=None, device="cpu")
    for i in range(n_models):
        zoo.register_factory(f"m{i}", "v1",
                             (lambda i=i: echo_stage(f"m{i}")))
    return zoo


def post(addr, body, headers=None, timeout=30.0):
    """(status, parsed body, response headers) — HTTPError unwrapped."""
    req = urllib.request.Request(
        addr, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        try:
            body = json.loads(e.read())
        except Exception:  # noqa: BLE001
            body = {}
        return e.code, body, dict(e.headers)


class TestAdmission:
    def test_request_identity(self):
        req = {"headers": {"x-tenant": "acme", "X-PRIORITY": "0"}}
        assert request_identity(req) == ("acme", 0)
        assert request_identity({"headers": {}}) == ("default", 1)
        # malformed priority keeps the default; out-of-range clamps
        assert request_identity(
            {"headers": {"X-Priority": "zz"}})[1] == 1
        assert request_identity(
            {"headers": {"X-Priority": "99"}})[1] == 2

    def test_decide_quota_and_priority(self):
        adm = AdmissionController(
            quotas={"noisy": TenantQuota(0.0, burst=2)},
            priority_pressure_limits={2: 0})
        assert adm.decide("noisy", 1, 0) is None
        assert adm.decide("noisy", 1, 0) is None
        assert adm.decide("noisy", 1, 0) == "quota"   # burst spent
        assert adm.decide("calm", 1, 0) is None       # unlimited
        assert adm.decide("calm", 2, 1) == "priority"  # pressure > 0
        assert adm.decide("calm", 2, 0) is None       # at the limit: ok
        assert adm.decide("calm", 0, 10**6) is None   # high never sheds
        stats = adm.stats()
        assert stats["shed"] == {"quota": 1, "priority": 1}
        assert stats["shed_by_tenant"]["noisy"] == 1

    def test_quota_429_over_http_no_failover(self):
        zoo = fresh_zoo()
        adm = AdmissionController(
            quotas={"noisy": TenantQuota(0.0, burst=1)})
        fleet = ServingFleet(n_engines=2, base_port=0, zoo=zoo,
                             admission=adm, tracing=False)
        try:
            assert fleet.post({"x": 1}, model="m0",
                              tenant="noisy")["served_by"] == "m0"
            # quota spent: 429 surfaces (a fleet-wide quota must NOT
            # fail over — the next replica would just spend it too)
            with pytest.raises(urllib.error.HTTPError) as err:
                fleet.post({"x": 2}, model="m0", tenant="noisy")
            assert err.value.code == 429
            # another tenant is unaffected
            assert fleet.post({"x": 3}, model="m0",
                              tenant="calm")["served_by"] == "m0"
            total_rej = sum(e.rejections.get("quota", 0)
                            for e in fleet.engines)
            assert total_rej == 1
            text = fleet.metrics_text()
            assert 'reason="quota"' in text
        finally:
            fleet.stop_all()
            zoo.close()

    def test_pressure_counts_source_backlog(self):
        # the dispatch queue alone is bounded by the in-flight token
        # count, which would leave the default tier-2 limit (8)
        # unreachable; the source-queue backlog is where overload shows
        from mmlspark_tpu_torch.serving.server import _ParkedRequest
        zoo = fresh_zoo()
        source = HTTPSource(port=0)
        engine = ServingEngine(source, zoo=zoo, tracing=False)
        try:
            assert engine._pressure() == 0
            for i in range(10):
                source.queue.put_nowait(
                    _ParkedRequest(f"r{i}", {"headers": {}}))
            assert engine._pressure() == 10    # > the default limit 8
        finally:
            source.close()
            zoo.close()

    def test_unknown_model_does_not_spend_quota(self):
        # routing runs BEFORE admission — mistyped model names answer
        # 404 without draining the tenant's token bucket
        zoo = fresh_zoo()
        adm = AdmissionController(
            quotas={"acme": TenantQuota(0.0, burst=1)})
        source = HTTPSource(port=0)
        engine = ServingEngine(source, zoo=zoo, admission=adm,
                               tracing=False).start()
        try:
            for i in range(3):
                code, _body, _ = post(source.address, {"x": i},
                                      {"X-Model": "ghost",
                                       "X-Tenant": "acme"})
                assert code == 404
            # the single burst token is still there for a real model
            code, body, _ = post(source.address, {"x": 9},
                                 {"X-Model": "m0", "X-Tenant": "acme"})
            assert code == 200 and body["served_by"] == "m0"
            # ... and spent now: the next request is the 429
            code, _body, headers = post(source.address, {"x": 10},
                                        {"X-Model": "m0",
                                         "X-Tenant": "acme"})
            assert code == 429 and headers.get("Retry-After")
            assert engine.metrics()["admission"]["admitted"] == 1
        finally:
            engine.stop()
            zoo.close()

    def test_low_priority_sheds_503_under_pressure(self):
        zoo = fresh_zoo()
        # limit -1: any pressure (>= 0) sheds tier 2 — the deterministic
        # stand-in for a saturated dispatch queue
        adm = AdmissionController(priority_pressure_limits={2: -1})
        source = HTTPSource(port=0)
        engine = ServingEngine(source, zoo=zoo, admission=adm,
                               tracing=False).start()
        try:
            code, body, headers = post(
                source.address, {"x": 1},
                {"X-Model": "m0", "X-Priority": "2"})
            assert code == 503 and "priority" in body["error"]
            assert headers.get("Retry-After")
            code, body, _ = post(source.address, {"x": 1},
                                 {"X-Model": "m0", "X-Priority": "0"})
            assert code == 200
        finally:
            engine.stop()
            zoo.close()


# ---------------------------------------------------------------------------
# the same scripted decisions through both packages
# ---------------------------------------------------------------------------

_DECISIONS = [("noisy", 1, 0), ("noisy", 1, 0), ("noisy", 2, 0),
              ("noisy", 1, 0), ("calm", 2, 5), ("calm", 2, 9),
              ("calm", 1, 10**6), ("calm", 0, 10**6), ("other", 1, 0),
              ("other", 1, 0), ("noisy", 0, 0)]


@pytest.mark.parametrize("limits", [None, {2: 4, 1: 8}],
                         ids=["default_tiers", "custom_tiers"])
def test_decisions_match_the_jax_package(limits):
    def run(ctl_cls, quota_cls):
        adm = ctl_cls(quotas={"noisy": quota_cls(0.0, burst=2),
                              "other": 0.0},
                      priority_pressure_limits=limits)
        return [adm.decide(*d) for d in _DECISIONS], adm.stats()

    got = run(AdmissionController, TenantQuota)
    assert got == run(JAdmissionController, JTenantQuota)
    assert "quota" in got[0] and "priority" in got[0]


@pytest.mark.parametrize("headers", [
    {"X-Tenant": " acme ", "X-Priority": "0"}, {"x-priority": "-3"},
    {"X-TENANT": "", "X-Priority": "1.5"}, {}])
def test_request_identity_matches_the_jax_package(headers):
    req = {"headers": headers}
    assert request_identity(req) == jrequest_identity(req)


# ---------------------------------------------------------------------------
# dynamic Retry-After (unit over an unstarted engine)
# ---------------------------------------------------------------------------


class TestDynamicRetryAfter:
    @pytest.fixture
    def eng(self):
        source = HTTPSource(port=0)
        engine = ServingEngine(source, echo_stage("m"), tracing=False,
                               slo=False, retry_after_max_s=30)
        yield engine
        source.close()

    def test_estimate_backlog_over_drain_rate(self, eng):
        assert eng._retry_after_s == 1
        # 40 rows backed up, draining at ~8 rows/s -> ceil(5) = 5 s
        eng._drained_rows.inc(80.0)        # 80 rows in the 10 s window
        for i in range(40):
            eng.source.queue.put(object())
        eng._update_retry_after(now=100.0)
        assert eng._retry_after_s == 5
        assert eng.source.retry_after_s == 5
        assert eng._retry_header() == "5"
        assert eng._retry_header(floor=9) == "9"

    def test_no_drain_rate_quotes_the_cap(self, eng):
        eng.source.queue.put(object())
        eng._update_retry_after(now=100.0)
        assert eng._retry_after_s == 30

    def test_clamped_to_window_and_rate_gated(self, eng):
        eng._drained_rows.inc(1.0)         # 0.1 rows/s
        for i in range(900):
            eng.source.queue.put(object())
        eng._update_retry_after(now=100.0)
        assert eng._retry_after_s == 30    # 9000 s clamps to the cap
        while not eng.source.queue.empty():
            eng.source.queue.get_nowait()
        eng._update_retry_after(now=100.2)   # inside the 0.5 s gate
        assert eng._retry_after_s == 30
        eng._update_retry_after(now=100.8)
        assert eng._retry_after_s == 1
