"""REST microservice: deploy/undeploy SiddhiQL apps over HTTP.

(reference: modules/siddhi-service — MSF4J service exposing
POST /siddhi/artifact/deploy and GET /siddhi/artifact/undeploy/{app},
SiddhiApi.java:31-62, SiddhiApiServiceImpl.java:42.)

Extras beyond the reference surface (operationally useful for a TPU-backed
deployment): list apps, push events into a stream, run store queries, and
snapshot/restore — all JSON over stdlib http.server (zero dependencies).

Observability surface: ``GET /metrics`` serves the Prometheus/
OpenMetrics text exposition over every deployed app's StatisticsManager
plus the process-global kernel profiler and the opt-in device telemetry
(core/statistics.prometheus_text); ``GET /stats`` serves the same data
as JSON.  Flight-recorder endpoints: ``GET /incidents`` lists incident
summaries, ``GET /incidents/{id}/bundle`` returns a full bundle,
``POST /siddhi/apps/{app}/debug/bundle`` snapshots one on demand, and
``GET /siddhi/apps/{app}/trace`` returns the Chrome trace-event JSON
(rt.dump_trace parity).  All scrape-ready on the zero-dependency server.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..core.runtime import SiddhiManager
from ..core.threads import engine_thread_name


class SiddhiService:
    def __init__(self, host: str = "127.0.0.1", port: int = 9090,
                 manager: Optional[SiddhiManager] = None):
        self.manager = manager or SiddhiManager()
        self.host = host
        self.port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ lifecycle

    def start(self):
        service = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):       # quiet
                pass

            def _send(self, code: int, payload):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _body(self):
                n = int(self.headers.get("Content-Length", 0))
                return self.rfile.read(n).decode() if n else ""

            def do_POST(self):
                try:
                    service._post(self)
                except Exception as e:  # noqa: BLE001 — service boundary
                    self._send(500, {"error": str(e)})

            def do_GET(self):
                try:
                    service._get(self)
                except Exception as e:  # noqa: BLE001 — service boundary
                    self._send(500, {"error": str(e)})

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True,
                                        name=engine_thread_name("siddhi-rest"))
        self._thread.start()
        return self

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        self.manager.shutdown()

    # ------------------------------------------------------------ routes

    def _post(self, h):
        parts = [p for p in h.path.split("/") if p]
        if parts == ["siddhi", "artifact", "deploy"]:
            rt = self.manager.create_siddhi_app_runtime(h._body())
            rt.start()
            return h._send(200, {"status": "deployed", "app": rt.name})
        if len(parts) == 4 and parts[:2] == ["siddhi", "apps"] and \
                parts[3] == "query":
            rt = self.manager.get_siddhi_app_runtime(parts[2])
            if rt is None:
                return h._send(404, {"error": f"no app '{parts[2]}'"})
            events = rt.query(h._body())
            return h._send(200, {"events": [
                {"timestamp": e.timestamp, "data": e.data}
                for e in (events or [])]})
        if len(parts) == 5 and parts[:2] == ["siddhi", "apps"] and \
                parts[3] == "streams":
            rt = self.manager.get_siddhi_app_runtime(parts[2])
            if rt is None:
                return h._send(404, {"error": f"no app '{parts[2]}'"})
            payload = json.loads(h._body())
            events = payload if isinstance(payload, list) else [payload]
            handler = rt.get_input_handler(parts[4])
            for ev in events:
                handler.send(ev["data"] if isinstance(ev, dict) else ev,
                             timestamp=(ev.get("timestamp")
                                        if isinstance(ev, dict) else None))
            return h._send(200, {"status": "sent", "count": len(events)})
        if len(parts) == 4 and parts[:2] == ["siddhi", "apps"] and \
                parts[3] == "persist":
            rt = self.manager.get_siddhi_app_runtime(parts[2])
            if rt is None:
                return h._send(404, {"error": f"no app '{parts[2]}'"})
            rev = rt.persist()
            return h._send(200, {"revision": rev})
        if len(parts) == 5 and parts[:2] == ["siddhi", "apps"] and \
                parts[3] == "debug" and parts[4] == "bundle":
            rt = self.manager.get_siddhi_app_runtime(parts[2])
            if rt is None:
                return h._send(404, {"error": f"no app '{parts[2]}'"})
            from ..core.flight import flight
            fl = flight()
            if not fl.enabled:
                return h._send(409, {"error": "flight recorder disabled "
                                              "(SIDDHI_TPU_FLIGHT=0)"})
            body = h._body()
            opts = json.loads(body) if body else {}
            bundle = fl.emit("on_demand", app=rt.name,
                             detail={"requested_by": "rest",
                                     "note": opts.get("note", "")},
                             runtime=rt)
            return h._send(200, {"id": bundle["id"],
                                 "kind": bundle["kind"]})
        if len(parts) == 5 and parts[:2] == ["siddhi", "apps"] and \
                parts[3] == "errors" and parts[4] in ("replay", "purge"):
            rt = self.manager.get_siddhi_app_runtime(parts[2])
            if rt is None:
                return h._send(404, {"error": f"no app '{parts[2]}'"})
            if rt.error_store is None:
                return h._send(409, {"error": "no error store configured"})
            body = h._body()
            opts = json.loads(body) if body else {}
            if parts[4] == "replay":
                n = rt.replay_errors(stream_id=opts.get("stream"),
                                     ids=opts.get("ids"))
                rt.flush()
                return h._send(200, {"replayed": n})
            n = rt.error_store.purge(app_name=rt.name, ids=opts.get("ids"))
            rt.resilience_metrics.errors_purged_total.inc(n)
            return h._send(200, {"purged": n})
        h._send(404, {"error": f"no route {h.path}"})

    def _get(self, h):
        parts = [p for p in h.path.split("/") if p]
        if len(parts) == 4 and parts[:3] == ["siddhi", "artifact",
                                             "undeploy"]:
            rt = self.manager.runtimes.pop(parts[3], None)
            if rt is None:
                return h._send(404, {"error": f"no app '{parts[3]}'"})
            rt.shutdown()
            return h._send(200, {"status": "undeployed", "app": parts[3]})
        if parts == ["siddhi", "apps"]:
            return h._send(200, {"apps": sorted(self.manager.runtimes)})
        if parts == ["health"]:
            return h._send(200, self._health_json())
        if parts == ["metrics"]:
            return self._send_metrics(h)
        if parts == ["stats"]:
            return h._send(200, self._stats_json())
        if parts == ["slo"]:
            return h._send(200, self._slo_json())
        if len(parts) == 4 and parts[:2] == ["siddhi", "apps"] and \
                parts[3] == "errors":
            rt = self.manager.get_siddhi_app_runtime(parts[2])
            if rt is None:
                return h._send(404, {"error": f"no app '{parts[2]}'"})
            if rt.error_store is None:
                return h._send(200, {"errors": [], "store": None})
            return h._send(200, {"errors": [
                e.summary() for e in rt.error_store.list(app_name=rt.name)],
                "store": type(rt.error_store).__name__})
        if len(parts) == 4 and parts[:2] == ["siddhi", "apps"] and \
                parts[3] == "trace":
            # Chrome trace-event JSON (Perfetto-loadable), parity with
            # rt.dump_trace but without touching the filesystem
            rt = self.manager.get_siddhi_app_runtime(parts[2])
            if rt is None:
                return h._send(404, {"error": f"no app '{parts[2]}'"})
            from ..core.tracing import tracer
            return h._send(200, tracer().to_dict())
        if parts == ["incidents"]:
            from ..core.flight import flight
            return h._send(200, {"incidents": flight().incidents()})
        if len(parts) == 3 and parts[0] == "incidents" and \
                parts[2] == "bundle":
            from ..core.flight import flight
            bundle = flight().bundle(parts[1])
            if bundle is None:
                return h._send(404, {"error": f"no bundle '{parts[1]}' "
                                              "(aged out or unknown)"})
            return h._send(200, bundle)
        h._send(404, {"error": f"no route {h.path}"})

    # ------------------------------------------------------------ health

    def _health_json(self) -> dict:
        """Liveness + per-sink circuit readiness: ``status`` stays "up"
        while the process serves; ``ready`` drops to False when any
        deployed sink's circuit is OPEN (fast-failing).  Overload is
        surfaced here too: ``status`` becomes "degraded" while any
        @Async buffer sits above its high watermark or a dispatch-storm
        watchdog incident (WD0xx) is on record."""
        from ..core.ledger import ledger
        led = ledger()
        apps, ready, degraded = {}, True, False
        for name, rt in self.manager.runtimes.items():
            sinks = {}
            for s in rt.sinks:
                breaker = getattr(s, "breaker", None)
                if breaker is None:
                    continue
                state = breaker.state
                sinks[s.stream_def.id] = {"circuit": state,
                                          "ready": state != "open"}
                if state == "open":
                    ready = False
            doc = {"started": rt._started, "sinks": sinks,
                   "errors_stored": (rt.error_store.count(rt.name)
                                     if rt.error_store is not None
                                     else 0)}
            saturated = [sid for sid, j in rt.junctions.items()
                         if j.saturated()]
            if saturated:
                doc["saturated_streams"] = saturated
                degraded = True
            wd = getattr(rt, "watchdog", None)
            if wd is not None and wd.incidents:
                doc["incidents"] = list(wd.incidents)
                degraded = True
            if led.slo_breached(name):
                # sustained @app:slo breach (core/ledger.py): the SLO001
                # bundle is already on the incident bus; health turns
                # degraded until the burn rate recovers
                doc["slo_breached"] = True
                degraded = True
            apps[name] = doc
        return {"status": "degraded" if degraded else "up",
                "ready": ready, "apps": apps}

    # ------------------------------------------------------------ metrics

    def _send_metrics(self, h):
        from ..core.profiling import profiler
        from ..core.statistics import prometheus_text
        managers = [rt.app_ctx.statistics_manager
                    for rt in self.manager.runtimes.values()
                    if rt.app_ctx.statistics_manager is not None]
        resilience = [rt.resilience_metrics
                      for rt in self.manager.runtimes.values()
                      if getattr(rt, "resilience_metrics", None) is not None]
        ingest = [rt.ingest_metrics
                  for rt in self.manager.runtimes.values()
                  if getattr(rt, "ingest_metrics", None) is not None]
        telemetry = [rt.device_telemetry
                     for rt in self.manager.runtimes.values()
                     if getattr(rt, "device_telemetry", None) is not None]
        from ..core.overload import fair_share
        from ..plan.xtenant import tenant_packer
        body = prometheus_text(managers, profiler(), resilience,
                               ingest, telemetry,
                               tenants=[fair_share(), tenant_packer()]
                               ).encode()
        h.send_response(200)
        h.send_header("Content-Type",
                      "text/plain; version=0.0.4; charset=utf-8")
        h.send_header("Content-Length", str(len(body)))
        h.end_headers()
        h.wfile.write(body)

    def _stats_json(self) -> dict:
        from ..core.ledger import ledger
        from ..core.profiling import profiler, rim_stats
        apps = {}
        for name, rt in self.manager.runtimes.items():
            if rt.app_ctx.statistics_manager is None:
                continue
            doc = rt.app_ctx.statistics_manager.snapshot()
            # compile-time analyzer findings ride the same surface: an
            # operator scraping /stats sees "this app's pattern has no
            # within bound" next to the runtime counters it explains
            if rt.analysis is not None:
                doc["analysis"] = rt.analysis.as_dicts()
                # plan-level report: automaton shapes, pruned-state
                # counts, predicted HBM/FLOP cost (analysis/plan_verify)
                plan = getattr(rt.analysis, "plan", None)
                if plan is not None:
                    doc["plan"] = plan.as_dict()
                # numeric-safety report: NS0xx value-range verdicts
                # grounded on the compiled plan (analysis/ranges)
                numeric = getattr(rt.analysis, "numeric", None)
                if numeric is not None:
                    doc["numeric"] = numeric.as_dict()
            # persistent-state schema report: which declarations govern
            # each snapshot element, and the app-level layout digest an
            # operator can diff across deploys (analysis/state_schema)
            schema = getattr(rt, "state_schema", None)
            if schema is not None:
                doc["state_schema"] = schema.as_dict()
            # per-query selection routing: whether the having / order-by
            # / limit tail runs in the device egress kernel or on the
            # host QuerySelector (with the blocking reason) — the live
            # counterpart of the T1 artifact's selection section
            selection = {
                qname: route
                for qname, qrt in getattr(rt, "query_runtimes",
                                          {}).items()
                for route in [getattr(qrt, "selection_route", None)]
                if route is not None}
            if selection:
                doc["selection"] = selection
            # live numeric sentinels (SIDDHI_TPU_NUMGUARD): overflow /
            # non-finite trip counters the static verdicts predicted
            from ..core.numguard import numeric_sentinels
            guard = numeric_sentinels(name, create=False)
            if guard is not None:
                doc["numguard"] = guard.snapshot()
            doc["ledger"] = ledger().snapshot(app=name)
            apps[name] = doc
        # process-global surfaces, mirrored from rt.statistics so the
        # three snapshot surfaces (/metrics, rt.statistics, here) agree
        from ..plan.shapes import shape_registry
        return {"apps": apps, "kernels": profiler().snapshot(),
                "rim": rim_stats().snapshot(),
                "shapes": shape_registry().snapshot()}

    def _slo_json(self) -> dict:
        """Per-app SLO posture + stream lag watermarks (the SLO engine's
        dedicated read surface; /metrics carries the same numbers as
        gauges)."""
        from ..core.ledger import ledger
        led = ledger()
        snap = led.snapshot()
        apps = {}
        for name, rt in self.manager.runtimes.items():
            entry = dict(snap["apps"].get(name, {}))
            cfg = getattr(rt, "slo_config", None)
            if cfg is not None and "slo" not in entry:
                entry["slo"] = {"config": cfg.as_dict()}
            apps[name] = entry
        return {"enabled": snap["enabled"], "apps": apps,
                "stage_seconds": snap["stage_seconds"]}
