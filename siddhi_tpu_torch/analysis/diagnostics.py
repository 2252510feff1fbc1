"""Typed diagnostics for the compile-time semantic analyzer.

Every finding the analyzer (siddhi_tpu_torch/analysis/analyzer.py) emits is a
:class:`Diagnostic` with a *stable* code.  Codes are API: tests, CI
gates, expected-warning allowlists and user suppression all key on them,
so a code's meaning never changes — retired codes are never reused.

Families:
  ``SA0xx`` — semantic / type errors and warnings (name resolution,
              expression typing, schema compatibility)
  ``SA02x`` — unbounded-state findings
  ``SA03x`` — partition-safety findings
  ``SA04x`` — dead-code findings
  ``SP0xx`` — TPU performance hazards (retrace storms, host fallbacks,
              float32 precision loss)
  ``PV0xx`` — plan-level verifier findings over the compiled Plan-IR
              (automaton well-formedness, liveness pruning, jaxpr
              kernel sanitation) — analysis/plan_verify.py
  ``PC0xx`` — static cost-model findings (HBM footprint, FLOP
              estimates, budget gates) — analysis/cost_model.py
  ``SC0xx`` — persistent-state schema / checkpoint compatibility
              (restore-time verification + the static registry audit)
              — analysis/state_schema.py + core/stateschema.py
  ``SA09x`` — attribute range / numeric annotation validation
              (``@attr:range(lo,hi)``, ``@app:rate``)
  ``NS0xx`` — numeric safety, static half: value-range & precision
              analysis over the interval lattice — analysis/ranges.py
  ``NS1xx`` — numeric safety, runtime half: on-device/host-rim
              overflow & NaN sentinels (SIDDHI_TPU_NUMGUARD)
              — core/numguard.py

The full catalog with meanings and fixes is rendered in
``docs/analysis.md``; :data:`CATALOG` is its single source of truth and
:func:`catalog_markdown` is the renderer the docs/tests share, so the
document can never drift from the code.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, List, Optional

from ..query_api.position import SourcePos


class Severity(Enum):
    ERROR = "error"
    WARNING = "warning"
    INFO = "info"

    @property
    def rank(self) -> int:
        return {"error": 0, "warning": 1, "info": 2}[self.value]


@dataclass(frozen=True)
class CatalogEntry:
    code: str
    severity: Severity
    title: str          # short kebab-ish label
    meaning: str        # what the finding tells the user
    fix: str            # how to make it go away


# -------------------------------------------------------------- the catalog

_C = CatalogEntry
_E, _W, _I = Severity.ERROR, Severity.WARNING, Severity.INFO

CATALOG: Dict[str, CatalogEntry] = {e.code: e for e in [
    _C("SA000", _E, "parse-error",
       "The app text failed to parse; nothing beyond this point was "
       "analyzed.",
       "Fix the syntax error at the reported position."),
    _C("SA001", _E, "unknown-source",
       "A query reads from (or writes a table operation against) a stream, "
       "table, window or aggregation that is defined nowhere in the app "
       "and produced by no other query.",
       "Define the source, or fix the misspelled identifier."),
    _C("SA002", _E, "unknown-attribute",
       "An expression references an attribute that does not exist on any "
       "stream in scope — at runtime this fails only when the query first "
       "compiles or (worse) executes.",
       "Fix the attribute name; check the stream definition it should "
       "come from."),
    _C("SA003", _E, "ambiguous-attribute",
       "An unqualified attribute name matches more than one stream in "
       "scope (e.g. both sides of a join).",
       "Qualify the reference with the stream id or alias "
       "(`s.price`)."),
    _C("SA004", _E, "type-mismatch",
       "An operator is applied to operand types it does not support: "
       "arithmetic on strings/bools, ordering comparison between a number "
       "and a string, logical and/or over non-boolean operands, or a "
       "function argument of the wrong type.",
       "Cast explicitly with convert(value, 'type') or fix the operand."),
    _C("SA005", _E, "non-boolean-condition",
       "A filter `[...]`, `having`, or join `on` expression does not "
       "evaluate to bool — the runtime would coerce or crash per batch.",
       "Make the condition a comparison/logical expression."),
    _C("SA006", _W, "lossy-promotion",
       "An int/long attribute is implicitly promoted to float in an "
       "expression.  Device lanes are float32: integers above 2^24 stop "
       "being exact, so equality and ordering can silently diverge from "
       "the host path.",
       "Use convert(x, 'double') explicitly, or keep both operands "
       "integer-typed."),
    _C("SA007", _W, "unknown-function",
       "A function call matches no builtin, aggregator, script function "
       "or statically known namespace.  It may resolve through an "
       "extension registered at runtime — or fail at app creation.",
       "Check the spelling/namespace, or register the extension before "
       "creating the runtime."),
    _C("SA008", _E, "insert-schema-mismatch",
       "A query inserts into an explicitly defined stream/table whose "
       "schema does not match the select clause (arity or incompatible "
       "attribute types).",
       "Align the select clause with the target definition."),
    # ---- unbounded state ------------------------------------------------
    _C("SA020", _W, "unbounded-pattern-state",
       "An `every` pattern has no `within` bound: every arming event "
       "keeps a partial match alive forever, so pattern state grows "
       "without bound on an infinite stream.",
       "Add `within <time>` to the pattern (or an `every (...) within` "
       "group bound)."),
    _C("SA021", _W, "unbounded-table-growth",
       "A query continuously inserts into a table that has no "
       "@PrimaryKey: rows are appended per event and never overwritten "
       "or evicted, so the table grows with the stream.",
       "Add @PrimaryKey('key') so writes upsert, or use update or "
       "insert / delete maintenance."),
    _C("SA022", _W, "unbounded-group-state",
       "A windowless aggregation with group-by keeps one running "
       "aggregate per distinct key forever.  With an unbounded key "
       "domain this is a slow memory leak.",
       "Add a #window handler to bound state, or group by a key with a "
       "bounded domain."),
    # ---- partition safety ----------------------------------------------
    _C("SA030", _W, "partition-shared-table-write",
       "A query inside a `partition` block writes to a table shared by "
       "all partition instances.  Every key's runtime mutates the same "
       "rows, so writes race and reads see cross-partition data.",
       "Include the partition key in the table's @PrimaryKey and write "
       "conditions, or move the write outside the partition."),
    _C("SA031", _W, "partition-shared-window-write",
       "A query inside a `partition` block inserts into a named window "
       "shared across partition instances — contents mix events from "
       "every key.",
       "Use an #InnerStream plus a per-query window, or partition-key-"
       "scope the window contents explicitly."),
    # ---- dead code ------------------------------------------------------
    _C("SA040", _I, "unused-stream",
       "A defined stream is never read by any query, never written to, "
       "and carries no @source/@sink — it is dead weight in the app.",
       "Delete the definition or wire a query/source to it."),
    _C("SA041", _I, "unused-attribute",
       "A stream attribute is never referenced by any query (and the "
       "stream is never forwarded whole via `select *` or a positional "
       "insert).  It still costs a column in every batch.",
       "Drop the attribute from the definition, or project it where "
       "intended."),
    # ---- fault tolerance ------------------------------------------------
    _C("SA050", _W, "onerror-store-without-error-store",
       "A stream declares `@OnError(action='STORE')` but neither the app "
       "(`@app:errorStore(...)`) nor the SiddhiManager "
       "(`set_error_store`) configures an error store — failed events "
       "will fall back to LOG and be lost instead of captured for "
       "replay.",
       "Add `@app:errorStore(type='memory')` (or type='sqlite') to the "
       "app, or call `SiddhiManager.set_error_store(...)` before "
       "creating the runtime."),
    _C("SA051", _W, "unknown-onerror-action",
       "`@OnError(action=...)` names an action other than "
       "LOG/STREAM/STORE/WAIT; the junction will fall back to LOG at "
       "runtime.",
       "Use one of the supported actions: LOG, STREAM, STORE, WAIT."),
    # ---- ingest protection ---------------------------------------------
    _C("SA060", _W, "unknown-overload-policy",
       "`@Async(overload=...)` names a policy other than "
       "BLOCK/SHED_OLDEST/SHED_NEW/STORE; the junction will fall back "
       "to BLOCK (bounded blocking admission) at runtime.",
       "Use one of the supported policies: BLOCK, SHED_OLDEST, "
       "SHED_NEW, STORE."),
    _C("SA061", _E, "invalid-overload-config",
       "`@Async` overload options are out of range: watermarks must "
       "satisfy 0 < overload.low < overload.high <= 1 and "
       "block.timeout.ms / drain.timeout.ms must be positive numbers — "
       "the runtime would silently clamp them to defaults.",
       "Fix the offending option; defaults are overload.high=0.8, "
       "overload.low=0.5, block.timeout.ms=60000, "
       "drain.timeout.ms=600000."),
    _C("SA062", _W, "overload-store-without-error-store",
       "A stream declares `@Async(overload='STORE')` but the app "
       "configures no error store — above the high watermark the "
       "junction degrades to bounded BLOCK instead of capturing "
       "overflow events for replay.",
       "Add `@app:errorStore(type='memory')` (or type='sqlite'), or "
       "call `SiddhiManager.set_error_store(...)`."),
    _C("SA063", _E, "invalid-quarantine-config",
       "`@quarantine` options are malformed: ts.slack.ms must be a "
       "non-negative integer and nan/wrap must be booleans — the "
       "runtime would silently fall back to the option's default.",
       "Fix the option, e.g. `@quarantine(ts.slack.ms='5000', "
       "nan='true', wrap='true')`."),
    # ---- service-level objectives --------------------------------------
    _C("SA070", _E, "invalid-slo-config",
       "`@app:slo` option values are malformed: latency.p99.ms and "
       "lag.ms must be positive numbers, window.blocks and "
       "breach.blocks positive integers — the runtime would silently "
       "ignore the bad value and fall back to the option's default.",
       "Fix the offending option, e.g. `@app:slo(latency.p99.ms='200', "
       "lag.ms='5000', window.blocks='128', breach.blocks='3')`."),
    _C("SA071", _W, "unknown-slo-option",
       "`@app:slo` carries an option the SLO engine does not read; it "
       "is ignored at runtime (likely a typo for latency.p99.ms / "
       "lag.ms / window.blocks / breach.blocks).",
       "Remove the option or correct its name."),
    _C("SA072", _W, "slo-without-targets",
       "`@app:slo` declares no latency.p99.ms and no lag.ms target — "
       "the SLO engine has nothing to evaluate, so no burn-rate gauge, "
       "health degradation or SLO001 bundle will ever fire.",
       "Add at least one target, e.g. "
       "`@app:slo(latency.p99.ms='200')`."),
    # ---- partition shard-out ------------------------------------------
    _C("SA080", _I, "partition-not-shardable",
       "SIDDHI_TPU_SHARDS would be ignored for this partitioned query: "
       "the app uses a feature that aggregates the whole key space "
       "through one engine's carry (absent `not ... for` deadline "
       "timers, on-device telemetry, or a statically dead automaton), "
       "so the keyed runtime stays a single monolithic slab on one "
       "device.",
       "Drop the blocking feature to shard out, or leave "
       "SIDDHI_TPU_SHARDS unset — the monolithic path is exact, just "
       "bounded by one device's HBM."),
    # ---- TPU performance hazards ---------------------------------------
    _C("SP001", _W, "retrace-slot-growth",
       "A device-eligible `every` pattern without `within` will grow its "
       "slot ring as partials accumulate; every doubling rebuilds and "
       "re-JITs the NFA step kernel — an unbounded recompilation storm "
       "the KernelProfiler surfaces as a rising compile_count.",
       "Add `within <time>` so live partials are bounded and the ring "
       "never grows."),
    _C("SP002", _I, "retrace-lane-growth",
       "A partitioned device query maps partition keys to device lanes "
       "that start at 8 and double on demand; each doubling retraces the "
       "kernels.  Bounded (log2 of key cardinality) but visible as "
       "compile_count churn while the key population ramps.",
       "Expected behavior; pre-warm with representative keys if the "
       "ramp-time latency matters."),
    _C("SP003", _W, "dynamic-window-param",
       "A window handler parameter is not a constant — the window shape "
       "would depend on runtime data, which the planner cannot compile "
       "to a fixed device ring (and the host path evaluates once, not "
       "per event).",
       "Use a literal window size/duration."),
    _C("SP010", _W, "host-fallback",
       "This query uses a construct the device NFA/aggregation compilers "
       "reject, so the planner will pin it to the single-threaded host "
       "oracle.  Correct, but orders of magnitude slower than the device "
       "path.",
       "See the message for the construct; restructure the query if "
       "device residency matters."),
    _C("SP011", _W, "int-precision-f32",
       "A pattern filter compares an int/long attribute against values "
       "above 2^24.  Device capture lanes are float32, so the compare "
       "rides an exact-integer companion lane or falls back to host — "
       "either way extra cost the query shape opted into silently.",
       "Keep compared integers under 2^24, or use double attributes."),
    _C("SP012", _I, "host-selection",
       "The query's selection tail (having / order-by / limit / offset) "
       "stays on the host QuerySelector: an atom is not "
       "device-expressible (string or extension aggregate, exact int64 "
       "sum, avg/stdDev float64 math, a constant that is not exactly "
       "two-float32 representable, an input-attribute or group-key "
       "reference) or the shape pins it (limit/offset over a sliding "
       "window shares slots with expired rows; order-by/limit inside a "
       "partition applies per key instance).  The aggregation itself "
       "may still run on device — only the selection tail pays a "
       "per-emission host pass.",
       "Keep having/order-by atoms to count/sum/min/max/…Forever select "
       "outputs compared against two-float-representable constants, or "
       "accept the host fallback (value-identical, slower)."),
    # ---- plan verifier: automaton well-formedness ------------------------
    _C("PV001", _E, "dangling-transition",
       "A compiled automaton transition targets a state id that does not "
       "exist — the transition table is malformed and the step kernel "
       "would index out of range (or silently clamp).",
       "Internal compiler invariant; report with the app that produced "
       "it.  The planner refuses to run a plan with this finding."),
    _C("PV002", _E, "accept-unreachable",
       "No path through the compiled automaton reaches the accept state: "
       "the pattern can NEVER match (e.g. a condition that folds to a "
       "constant false, or a SEQUENCE leading kleene with min >= 2 whose "
       "per-event barrier provably kills every sub-min accumulator).  "
       "The kernel would burn device time scanning events for nothing.",
       "Fix the contradictory condition / kleene bounds — or delete the "
       "query.  With pruning on, the engine skips the device step for "
       "such plans (match output is identically empty)."),
    _C("PV003", _W, "unreachable-state",
       "An automaton state is unreachable from the start state — it can "
       "never hold a partial match, but still widens the transition "
       "matrices and capture banks every step pays for.",
       "Internal compiler invariant for chain automata; report it with "
       "the app.  Liveness pruning removes prunable cases."),
    _C("PV004", _I, "states-pruned",
       "Liveness pruning removed automaton states that could never "
       "contribute to a match (statically-false skippable conditions, "
       "dead or-sides), shrinking the transition tables and capture "
       "banks.  Match output is unchanged — equivalence is test-asserted.",
       "Nothing to do; informational.  Set SIDDHI_TPU_NFA_PRUNE=0 to "
       "disable pruning when diffing against an unpruned plan."),
    _C("PV005", _W, "within-starved",
       "The pattern's `within` bound is smaller than (or equal to) the "
       "summed `not ... for t` waiting times on the match path: every "
       "partial expires before the absence chain can confirm, so the "
       "pattern can match only degenerately (or never).",
       "Raise the `within` bound above the summed absent waits, or "
       "shorten the waits."),
    # ---- plan verifier: jaxpr kernel sanitation --------------------------
    _C("PV010", _E, "jaxpr-host-callback",
       "A jitted step's jaxpr contains a host callback primitive "
       "(pure_callback/io_callback/debug print).  Every step round-trips "
       "to Python — the kernel is effectively host-bound and the TPU "
       "pipeline serializes on it.",
       "Remove the callback from the compiled path (host work belongs in "
       "ingest/egress, not inside the step)."),
    _C("PV011", _W, "jaxpr-float64",
       "A jitted step's jaxpr carries float64 values.  TPUs emulate f64 "
       "in software (an order of magnitude slower) and the engine's lane "
       "contract is float32 — an upcast usually indicates an accidental "
       "numpy float64 constant leaking into the trace.",
       "Cast constants/operands to float32 (or int32) before the jit "
       "boundary."),
    _C("PV012", _W, "jaxpr-dynamic-shape",
       "A step function could not be traced to a static jaxpr: its "
       "shapes depend on data (boolean masking, nonzero without a static "
       "size, host round-trips mid-trace).  Under jit this retraces or "
       "falls back to host per batch.",
       "Use fixed-size forms (masking via where, nonzero with size=) so "
       "the trace is shape-static."),
    _C("PV013", _W, "jaxpr-unexpected-gather",
       "A jitted step that should be purely elementwise (e.g. the filter "
       "column program) contains gather/scatter primitives — lane-"
       "crossing addressing that breaks TPU vectorization and usually "
       "signals an expression compiled into indexed loads.",
       "Restructure the expression to elementwise column math; "
       "gather/scatter belongs only in the NFA/egress kernels that "
       "declare it."),
    # ---- static cost model ----------------------------------------------
    _C("PC001", _I, "plan-cost-summary",
       "Static cost-model estimate for a compiled plan: persistent HBM "
       "state bytes (state banks, slot rings, capture banks, agg tables "
       "at current lane counts) and estimated FLOPs per ingested event.  "
       "Predicted-vs-measured live bytes ride bench.py JSON.",
       "Nothing to do; informational.  The numbers feed `rt.analysis`, "
       "GET /stats and the bench.py --fail-on-hbm-budget gate."),
    _C("PC002", _W, "hbm-budget-exceeded",
       "The plan's predicted persistent HBM footprint exceeds the "
       "configured budget (analyze --plan --hbm-budget / bench.py "
       "--fail-on-hbm-budget).  Slot-ring or lane growth at runtime "
       "would start from an already-over-budget base.",
       "Shrink partition lanes / slots / window sizes, shard the plan "
       "across chips, or raise the budget deliberately."),
    _C("PC003", _W, "flops-per-event-heavy",
       "The estimated per-event FLOP cost of a step is high (deep "
       "condition chains x wide slot rings x many lanes).  Throughput "
       "will be compute-bound well below the ingest path's capability.",
       "Reduce condition complexity or slot width, or split the pattern "
       "across queries/chips."),
    # ---- engine concurrency audit (analyze --engine) --------------------
    _C("CE001", _E, "lock-order-cycle",
       "The static lock-order graph of the engine source contains a "
       "cycle: two (or more) locks are acquired in opposite orders on "
       "different code paths.  Two threads interleaving those paths can "
       "deadlock the host rim.",
       "Break the cycle: pick one canonical order, or narrow one region "
       "so it no longer acquires the second lock."),
    _C("CE002", _W, "callback-under-lock",
       "A user-supplied callback / extension hook (on_* attribute, "
       "listener or subscriber iteration) is invoked while an engine "
       "lock is held.  The callback can re-enter the engine and try to "
       "take the same lock — the circuit-breaker self-deadlock "
       "class.",
       "Collect pending callbacks under the lock, invoke them after "
       "release (see CircuitBreaker._fire_pending)."),
    _C("CE003", _W, "sleep-in-engine",
       "time.sleep in engine code.  Sleeps are uninterruptible: a "
       "shutdown request waits out the full remaining sleep (or the "
       "whole backoff ladder), and under a lock they stall every other "
       "thread.",
       "Wait on a threading.Event with a timeout instead "
       "(stop_event.wait(delay) returns early when shutdown sets it)."),
    _C("CE004", _W, "join-without-timeout",
       "A timeout-less Thread.join() inside a locked region or worker "
       "body.  If the joined thread is wedged (or is the current thread "
       "via a callback cycle), the join blocks forever and takes the "
       "lock holder with it.",
       "join(timeout=...) and handle the still-alive case (log, leak-"
       "report, force-continue)."),
    _C("CE005", _W, "queue-op-without-timeout",
       "A blocking Queue.put()/get() without a timeout inside a locked "
       "region or worker body.  A full (or empty) queue parks the "
       "thread forever while it may be holding a lock others need — the "
       "forever-blocking put class.",
       "Use timeouts (put(x, timeout=...)) with an overflow/empty "
       "policy, or make the queue bounded-with-shedding."),
    _C("CE006", _W, "io-under-lock",
       "File or socket I/O (open/write/socket/urlopen/json.dump to a "
       "file) while holding an engine lock.  I/O latency is unbounded; "
       "every thread contending that lock inherits it.",
       "Stage the data under the lock, do the I/O after release (see "
       "FlightRecorder.emit: bundle built and dumped outside the "
       "RLock)."),
    _C("CE007", _W, "wait-without-timeout",
       "A timeout-less Event/Condition .wait() in a worker body.  If "
       "the notifying side dies first (or shutdown races the notify), "
       "the worker parks forever and the thread leaks past join.",
       "wait(timeout=...) in a loop that re-checks the predicate and "
       "the stop flag."),
    _C("CE008", _I, "unnamed-engine-thread",
       "A threading.Thread/Timer is constructed without a siddhi- "
       "prefixed name from core/threads.py.  Leaked or wedged threads "
       "show up in dumps and the tier-1 leak sentinel as anonymous "
       "Thread-N, unattributable to a component.",
       "Name it via core.threads.engine_thread_name and register the "
       "prefix in ENGINE_THREAD_PREFIXES."),
    # ---- engine hot-path lint (@hot_path functions) ---------------------
    _C("CE101", _W, "env-read-on-hot-path",
       "An os.environ read (direct, or via a helper that is not one of "
       "the verified fast-idiom readers) inside a @hot_path function.  "
       "os.environ.get costs ~0.9 us per call (key encode + value "
       "decode) — ~9x a plain dict read — and these "
       "functions run per block or per event.",
       "Hoist the read to import/construction time, or use the "
       "os.environ._data fast idiom (core/ledger.py ledger_enabled) "
       "when the knob must stay flippable mid-process."),
    _C("CE102", _W, "eager-to-events-on-hot-path",
       "A .to_events() call inside a @hot_path function.  Materializing "
       "per-event objects from a columnar chunk allocates one Event per "
       "row — the GC find; hot paths must stay columnar and only "
       "materialize on explicitly lazy/legacy branches.",
       "Operate on the chunk's columns, or route through LazyEvents so "
       "materialization happens only if a consumer asks."),
    _C("CE103", _W, "dict-per-event-on-hot-path",
       "A dict/list comprehension or per-row dict build inside a loop "
       "over events/rows in a @hot_path function.  One allocation per "
       "event resurrects the per-event interpreter overhead the "
       "columnar rim exists to avoid.",
       "Build one columnar structure per block (arrays, or a single "
       "dict of columns) instead of a dict per row."),
    # ---- runtime lock-witness (SIDDHI_TPU_LOCKWITNESS=1) ----------------
    _C("LW001", _E, "lock-order-inversion",
       "The runtime lock-witness observed two locks acquired in "
       "opposite orders (A->B on one thread, B->A on another, or "
       "against the static graph).  The interleaving that deadlocks "
       "exists; only scheduling luck has kept it latent.",
       "Fix the acquisition order (see the incident bundle's "
       "first/second edges and thread names); the static CE001 pass "
       "shows every source region involved."),
    _C("LW002", _W, "long-lock-hold",
       "A witnessed engine lock was held longer than "
       "SIDDHI_TPU_LOCKWITNESS_HOLD_MS (default 100 ms).  Long holds "
       "turn the lock into a convoy: every contending thread inherits "
       "the full hold latency.",
       "Move slow work (I/O, device sync, callbacks) outside the lock; "
       "the bundle names the lock and the holding thread."),
    _C("SC001", _E, "schema-mismatch-on-restore",
       "A snapshot's embedded state schema does not match the live "
       "runtime's: a field, dim, element or declared version differs.  "
       "The restore was refused BEFORE any carry was touched — the "
       "message carries the field-level diff that a raw restore would "
       "have turned into a jax shape error (or silent misread) deep "
       "inside the step.",
       "Restore into a runtime built from the same app and config, or "
       "migrate the snapshot; the diff names every offending slot."),
    _C("SC002", _W, "unregistered-persistent-state",
       "A current_state() implementer carries no @persistent_schema "
       "declaration (or its payload holds keys the declaration does "
       "not describe) — that state is invisible to the checkpoint "
       "compatibility verifier and restores unchecked.",
       "Declare the schema with @persistent_schema on the class that "
       "defines current_state; update the declaration when the payload "
       "gains keys."),
    _C("SC003", _W, "non-portable-payload",
       "A snapshot payload raw-pickles a class instance outside the "
       "portable allowlist (plain data + ndarrays).  Such a snapshot "
       "only restores under the exact same engine build — a refactor "
       "that renames the class orphans every saved revision.",
       "Persist plain dicts/lists/ndarrays; encode objects explicitly "
       "in current_state and rebuild them in restore_state."),
    _C("SC004", _E, "elastic-dim-off-ladder",
       "An elastic (grow-ladder) dim in the snapshot — e.g. the NFA "
       "key-lane capacity K — is not a power-of-two factor away from "
       "the live value.  Capacities only ever grow by doubling, so an "
       "off-ladder value means a tampered or foreign snapshot.",
       "Restore a snapshot taken by the same app (ladder values align "
       "by construction), or fix the corrupted header."),
    _C("SC005", _E, "shard-routing-drift",
       "The snapshot's per-shard sections do not match the runtime: "
       "different shard count, or the pinned FNV-1a routing digest "
       "changed.  Key→shard assignment is modular in the shard count, "
       "so restored keys would land on the wrong shard.",
       "Restore with the same SIDDHI_TPU_SHARDS the snapshot was taken "
       "with; never change the routing hash (it is checkpoint ABI)."),
    _C("SC006", _E, "incremental-chain-gap",
       "An incremental revision chain is broken at restore: an "
       "increment's recorded base revision is missing from the store "
       "or is not the previously applied link.  Replaying over the gap "
       "would silently restore stale state.",
       "Restore from the latest intact full revision, or re-persist; "
       "never delete intermediate _inc revisions without their "
       "successors."),
    _C("SA090", _E, "invalid-range-annotation",
       "An @attr:range / @app:rate numeric-safety annotation is "
       "malformed: wrong arity, a non-numeric bound, an unknown or "
       "non-numeric attribute, or a non-positive rate.  The numeric "
       "verifier ignores the annotation and falls back to conservative "
       "dtype bounds.",
       "Write @attr:range(attr, lo, hi) with numeric bounds naming a "
       "numeric attribute of the stream, and @app:rate(events_per_sec) "
       "with a positive number."),
    _C("SA091", _E, "inverted-range-bounds",
       "An @attr:range annotation declares lo > hi — an empty range.  "
       "The declaration is ignored; the attribute keeps conservative "
       "dtype bounds.",
       "Swap the bounds so lo <= hi."),
    _C("SA092", _W, "range-wider-than-dtype",
       "An @attr:range annotation declares bounds outside what the "
       "attribute's dtype can represent (e.g. an int attribute with a "
       "bound past 2^31).  The range is clamped to the dtype's bounds, "
       "so the declaration adds no information there.",
       "Tighten the declared range to the dtype, or widen the "
       "attribute's type (int -> long, float -> double)."),
    _C("NS001", _W, "int-overflow-reachable",
       "Integer arithmetic can exceed its result dtype under the "
       "declared value ranges: the interval of a +,-,*,sum() over "
       "int/long lanes escapes int32/int64 bounds, so the computation "
       "can silently wrap on device (jax int ops wrap, they do not "
       "raise).",
       "Tighten @attr:range bounds, widen the attribute to long, or "
       "shrink the window so the accumulated bound fits."),
    _C("NS002", _W, "division-by-zero-reachable",
       "A divisor's value interval contains 0 (division or modulo), so "
       "a div-by-zero / NaN-propagation path is reachable.  On device "
       "the result is inf/NaN (float) or an undefined wrapped value "
       "(int) that silently poisons downstream aggregates.",
       "Exclude 0 from the divisor's @attr:range, or guard the "
       "division with a filter / ifThenElse on the divisor."),
    _C("NS003", _W, "f32-precision-budget-exceeded",
       "A float32 accumulation's error budget is exceeded: window "
       "span x rate x max|value| puts the running sum past 2^24 ulp, "
       "where naive f32 addition starts dropping whole updates.  "
       "Applies to uncompensated accumulators (incremental-aggregation "
       "slabs); gagg/wagg running sums are compensated (TwoSum/Kahan) "
       "and exempt.",
       "Declare @numeric(sum='compensated') on the aggregation (exact "
       "compensated slab lanes, parity-proven), tighten @attr:range, "
       "or shorten the bucket duration."),
    _C("NS004", _W, "ts32-horizon-wrap",
       "A window span, `within` bound or absent-pattern gap timer "
       "approaches the int32 millisecond horizon (~24.8 days; the "
       "usable half-horizon is ~12.4 days after rebase headroom).  "
       "Device timestamps ride int32 offsets (ops/ts32.py); a span "
       "this long can make offset arithmetic wrap or a single ring "
       "span unrepresentable.",
       "Shorten the window/within span below ~12 days, or route the "
       "query to the host engine (@app:engine('host'))."),
    _C("NS005", _W, "count-lane-saturation",
       "A count lane (int32: gagg gcnt, wagg cnt, NFA __cnt, slab "
       "cnt) can reach 2^31 under the declared window span and event "
       "rate — the counter saturates/wraps and every derived avg "
       "silently corrupts.",
       "Shorten the window, lower the declared @app:rate if it "
       "overstates reality, or route to the host engine."),
    _C("NS006", _W, "lossy-egress-demotion",
       "An int/long output attribute whose declared range exceeds "
       "2^24 rides a float32 lane through the fused-egress slab on "
       "the device path — values past 2^24 are rounded to the nearest "
       "representable f32, so exact integers come back perturbed.",
       "Keep device-path integer outputs within +/-2^24, or accept "
       "rounding; the host engine (@app:engine('host')) keeps exact "
       "integers."),
    _C("NS101", _W, "numeric-sentinel-tripped",
       "A SIDDHI_TPU_NUMGUARD runtime sentinel observed a numeric "
       "hazard live: a non-finite float aggregate, an integer "
       "accumulator inside its overflow guard band, a count lane near "
       "int32 saturation, or a ts32 rebase with thin headroom.  The "
       "incident is on the flight bus with the site and reading.",
       "Treat as confirmation of the static NS0xx finding at that "
       "site: apply its fix, then re-run with NUMGUARD armed to "
       "verify the sentinel stays quiet."),
    _C("SC010", _E, "schema-evolution-without-version-bump",
       "Two snapshots declare the same schema name and version but "
       "different layout digests — the persisted layout changed "
       "without bumping the declaration's version, so old revisions "
       "would be misread as the new layout.",
       "Bump version= in the @persistent_schema declaration whenever "
       "the layout changes (and write a migration if old snapshots "
       "must stay restorable)."),
]}


@dataclass
class Diagnostic:
    """One analyzer finding, anchored to a source position when the parse
    carried one (fluent-API apps have no text, hence no spans)."""
    code: str
    message: str
    severity: Severity = None  # default: catalog severity
    pos: Optional[SourcePos] = None
    query: Optional[str] = None      # query/partition context name
    extra: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        if self.severity is None:
            self.severity = CATALOG[self.code].severity

    @property
    def line(self) -> int:
        return self.pos.line if self.pos else -1

    @property
    def col(self) -> int:
        return self.pos.col if self.pos else -1

    def as_dict(self) -> Dict[str, Any]:
        d = {"code": self.code,
             "severity": self.severity.value,
             "title": CATALOG[self.code].title,
             "message": self.message,
             "line": self.line,
             "col": self.col}
        if self.query:
            d["query"] = self.query
        if self.extra:
            d["extra"] = self.extra
        return d

    def render(self, filename: str = "<app>") -> str:
        loc = (f"{filename}:{self.line}:{self.col}" if self.pos
               else filename)
        ctx = f" [{self.query}]" if self.query else ""
        return (f"{loc}: {self.severity.value} {self.code} "
                f"({CATALOG[self.code].title}): {self.message}{ctx}")


_FAMILIES = (
    ("SA00", "Semantic & type checking"),
    ("SA02", "Unbounded state"),
    ("SA03", "Partition safety"),
    ("SA04", "Dead code"),
    ("SA05", "Fault tolerance"),
    ("SA06", "Ingest protection"),
    ("SA07", "Service-level objectives"),
    ("SA08", "Partition shard-out"),
    ("SA09", "Attribute range declarations"),
    ("SP0", "TPU performance hazards"),
    ("PV00", "Plan verifier — automaton"),
    ("PV01", "Plan verifier — jaxpr kernel sanitizer"),
    ("PC0", "Static cost model"),
    ("CE0", "Engine concurrency audit"),
    ("CE1", "Engine hot-path lint"),
    ("LW0", "Runtime lock-witness"),
    ("SC0", "Persistent-state schema"),
    ("NS0", "Numeric safety — static value-range analysis"),
    ("NS1", "Numeric safety — runtime sentinels"),
)


def catalog_markdown() -> str:
    """Render :data:`CATALOG` as the markdown section embedded in
    docs/analysis.md.  The docs file must contain this text verbatim
    (asserted by tests/test_analysis.py), so code and docs cannot drift;
    regenerate with ``python -m siddhi_tpu_torch.analyze --catalog-md``."""
    lines = ["<!-- generated by siddhi_tpu_torch.analysis.diagnostics."
             "catalog_markdown(); do not edit by hand -->", ""]
    rendered = set()
    for prefix, title in _FAMILIES:
        codes = [c for c in sorted(CATALOG)
                 if c.startswith(prefix) and c not in rendered]
        if not codes:
            continue
        rendered.update(codes)
        lines += [f"### {title}", "",
                  "| code | severity | title | meaning | fix |",
                  "|---|---|---|---|---|"]
        for code in codes:
            e = CATALOG[code]
            row = [code, e.severity.value, e.title,
                   e.meaning.replace("|", "\\|"),
                   e.fix.replace("|", "\\|")]
            lines.append("| " + " | ".join(row) + " |")
        lines.append("")
    leftover = sorted(set(CATALOG) - rendered)
    if leftover:      # a new family without a _FAMILIES entry still renders
        lines += ["### Other", ""]
        lines += [f"- `{c}` ({CATALOG[c].severity.value}) "
                  f"{CATALOG[c].title}: {CATALOG[c].meaning}"
                  for c in leftover]
        lines.append("")
    return "\n".join(lines)


class DiagnosticSink:
    """Collector passed through the passes; dedupes exact repeats."""

    def __init__(self):
        self.diagnostics: List[Diagnostic] = []
        self._seen = set()

    def emit(self, code: str, message: str, pos: Optional[SourcePos] = None,
             query: Optional[str] = None,
             severity: Optional[Severity] = None, **extra) -> None:
        """``severity`` overrides the catalog default — the numeric
        verifier downgrades findings to INFO when the verdict rests only
        on undeclared conservative dtype bounds (no @attr:range)."""
        key = (code, message, pos.line if pos else -1,
               pos.col if pos else -1, query)
        if key in self._seen:
            return
        self._seen.add(key)
        self.diagnostics.append(
            Diagnostic(code, message, severity=severity, pos=pos,
                       query=query, extra=extra))
