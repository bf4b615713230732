"""Task cells: whole protocol evaluations through the port's evaluator
entry (``EvaluatorZeroShot.evaluate_tasks`` or
``EvaluatorFewShot.evaluate_tasks``) with the configuration the CLI builds
from the cell's options.

The work is the same in every run: the feature tables come from the
configuration's ``data_seed``, and the traffic's ``evaluations`` are a
fixed set of sampler seeds (the EM's cost depends on its tasks, so a set
drawn anew for every run would change the work from run to run). Set-up
makes the tables on the card and warms up on two batches of another
evaluation. The window runs the set in cycles, each in an order drawn from
the run's seed, until ``seconds`` have passed and the cycle under way has
ended; the clock stops synchronised at its end.

What the timed path handed back is recorded as it goes: each batch's task
draws (the row indices the evaluator sampled), predictions and
accuracies. Afterwards every recorded draw is checked against the
protocol's rules, and a sample of the set's tasks, drawn from the run's
seed, is solved again by the configuration's plain reference
(benchmark/reference/<reference>.py) on the very rows the program got;
every cycle's predictions and accuracies of those tasks are compared with
it."""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from . import dev, features, trace, work
from .spec import ROOT

CHECK_BLOCK = 50
# batches of the traced stretch (``--trace 1``): the blocking batch 0 and
# one of the pipelined route
TRACE_BATCHES = 2


def _say(msg):
    print(msg, file=sys.stderr, flush=True)


def eval_seed(base, i):
    """The sampler seed of the set's evaluation ``i`` (-1: the warm-up)."""
    return int(np.random.SeedSequence([base, 7, i + 1]).generate_state(1)[0])


class Recorder:
    """Records what the timed path hands back: each batch's task draws as
    the evaluator shards them (``shard_task_batch``: the query rows, and the
    support rows few-shot), each batch's predictions and accuracies in batch
    order (the blocking ``run_task`` and the deferred and fused results'
    ``finalize``), and the evaluator's phase timers (a recording subclass
    of ``PhaseTimer``). ``install`` swaps them in; ``remove`` restores the
    program's own."""

    def __init__(self):
        self.batches, self.draws, self.timers = [], [], []

    def install(self):
        from transductive_clip_tpu_torch.core.profiling import PhaseTimer
        from transductive_clip_tpu_torch.eval import few_shot, zero_shot
        from transductive_clip_tpu_torch.methods.base import (
            DeferredTaskResult,
            TransductiveMethod,
        )

        rec = self
        self._saved = [(TransductiveMethod, "run_task",
                        TransductiveMethod.run_task),
                       (DeferredTaskResult, "finalize",
                        DeferredTaskResult.finalize)]
        for mod in (zero_shot, few_shot):
            self._saved += [(mod, "PhaseTimer", mod.PhaseTimer),
                            (mod, "shard_task_batch", mod.shard_task_batch)]
        run_task = TransductiveMethod.run_task
        finalize = DeferredTaskResult.finalize

        def recorded_run_task(method, task_dic, shot=None):
            logs = run_task(method, task_dic, shot)
            rec.batches.append((np.asarray(logs["preds"]),
                                np.asarray(logs["acc"])[:, -1]))
            return logs

        def recorded_finalize(result, host, elapsed_per_task):
            logs = finalize(result, host, elapsed_per_task)
            rec.batches.append((np.asarray(logs["preds"]),
                                np.asarray(logs["acc"])[:, -1]))
            return logs

        def recording_shard(shard):
            def recorded(batch, group):
                out = shard(batch, group)
                if isinstance(out, np.ndarray):
                    rec.draws.append((None, np.array(out)))
                elif (isinstance(out, tuple) and len(out) == 2
                      and all(isinstance(a, np.ndarray) for a in out)):
                    rec.draws.append((np.array(out[0]), np.array(out[1])))
                return out
            return recorded

        class RecordingTimer(PhaseTimer):
            def __init__(self):
                super().__init__()
                rec.timers.append(self)

        TransductiveMethod.run_task = recorded_run_task
        DeferredTaskResult.finalize = recorded_finalize
        for mod in (zero_shot, few_shot):
            mod.PhaseTimer = RecordingTimer
            mod.shard_task_batch = recording_shard(mod.shard_task_batch)

    def remove(self):
        for owner, name, value in self._saved:
            setattr(owner, name, value)

    def take(self):
        """({"answers", "draws"} of the evaluation since the last take, its
        timers)."""
        out = {"answers": self.batches, "draws": self.draws}, self.timers
        self.batches, self.draws, self.timers = [], [], []
        return out


def _options(cfg, tr, seed):
    """The CLI's --opts for the cell: the protocol and nothing else."""
    opts = ["dataset", cfg["dataset"], "method", cfg["method"],
            "num_classes_test", str(cfg["n_class"]),
            "shots", str(tr["shots"]), "number_tasks", str(tr["number_tasks"]),
            "batch_size", str(tr["batch_size"]), "n_query", str(tr["n_query"]),
            "k_eff", str(tr["k_eff"]), "T", str(cfg["T"]),
            "seed", str(seed), "save_results", "False"]
    return opts


def _resolved(args, device, few):
    """What each ``auto`` knob of the path resolves to on this device, as
    the program resolves it."""
    from transductive_clip_tpu_torch.eval.zero_shot import (
        resolve_defer_fetch,
        resolve_fused_dispatch,
    )
    from transductive_clip_tpu_torch.methods import (
        get_few_shot_method,
        get_zero_shot_method,
    )
    from transductive_clip_tpu_torch.methods.base import _matching_backend

    method = (get_few_shot_method if few else get_zero_shot_method)(
        args.name_method, device=device, args=args)
    fused = resolve_fused_dispatch(args, True)
    return {"dirichlet_solver": getattr(method, "solver", None),
            "fused_dispatch": fused,
            "defer_fetch": resolve_defer_fetch(args, device, fused),
            "matching_backend": "none (argmax accuracy)" if few
            else _matching_backend(args, device),
            "compact_first_iter": args.get("compact_first_iter"),
            "device_gather": args.get("device_gather")}


def tables(cfg, few, device):
    """The cell's feature tables, the same for every run: (test features,
    test labels) and, few-shot, the train split's."""
    import torch

    n_class, base = int(cfg["n_class"]), int(cfg["data_seed"])
    spec, T = cfg["features"], float(cfg["T"])
    text = features.class_embeddings(spec, n_class, base, device)
    with torch.no_grad():
        test = features.softmax_table(spec, text, (base, 0),
                                      int(cfg["test_per_class"]), T, device)
        train = None
        if few:
            train = features.softmax_table(spec, text, (base, 1),
                                           int(cfg["train_per_class"]), T,
                                           device)
    return test, train


def protocol(cfg, tr):
    return {"n_class": int(cfg["n_class"]), "n_query": int(tr["n_query"]),
            "k_eff": int(tr["k_eff"]), "shots": int(tr["shots"])}


def run(cell, seed, seconds, want_trace, device="cuda:0"):
    t_setup = time.perf_counter()
    import torch

    from transductive_clip_tpu_torch.core.config import load_full_config
    from transductive_clip_tpu_torch.eval.few_shot import EvaluatorFewShot
    from transductive_clip_tpu_torch.eval.zero_shot import EvaluatorZeroShot
    from transductive_clip_tpu_torch.methods.base import note_host_fallback
    from transductive_clip_tpu_torch.ops.common import to_host

    cfg, tr = cell.config, cell.traffic
    few = int(tr["shots"]) > 0
    device = torch.device(device)
    n_class = int(cfg["n_class"])
    base = int(cfg["data_seed"])
    n_set = int(tr["evaluations"])
    test, train = tables(cfg, few, device)
    args = load_full_config(opts=_options(cfg, tr, eval_seed(base, -1)),
                            config_root=os.path.join(ROOT, "config"))
    _say(f"resolved on {dev.name(device)}: {_resolved(args, device, few)}")
    evaluator = (EvaluatorFewShot if few else EvaluatorZeroShot)(
        device=device, args=args)

    def evaluate(j, n_tasks=int(tr["number_tasks"])):
        args.seed = eval_seed(base, j)
        args.number_tasks = n_tasks
        if few:
            return evaluator.evaluate_tasks(train[0], train[1], test[0],
                                            test[1])
        return evaluator.evaluate_tasks(test[0], test[1])

    rec = Recorder()
    rec.install()
    try:
        # two batches run every shape and kernel of an evaluation: the
        # blocking batch 0 with its guard, and a pipelined one
        evaluate(-1, 2 * int(tr["batch_size"]))
        dev.sync(device)
        rec.take()
        setup_s = time.perf_counter() - t_setup

        n_batches = int(tr["number_tasks"]) // int(tr["batch_size"])
        tasks_per_eval = n_batches * int(tr["batch_size"])
        cycles, timers = [], []
        syncs0, fallbacks0 = to_host.syncs, note_host_fallback.count
        dev.reset_peak(device)
        t0 = time.perf_counter()
        while True:
            outputs = [None] * n_set
            for j in cycle_order(seed, len(cycles), n_set):
                t_eval, s_eval = time.perf_counter(), to_host.syncs
                evaluate(int(j))
                dev.sync(device)
                took = time.perf_counter() - t_eval
                outputs[j], tm = rec.take()
                timers += tm
                _say(f"cycle {len(cycles)} evaluation {j}: {took:.4f} s, "
                     f"{to_host.syncs - s_eval} host syncs")
            cycles.append(outputs)
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
        peak = dev.peak_bytes(device)
        syncs = to_host.syncs - syncs0
        fallbacks = note_host_fallback.count - fallbacks0

        traced, untraced_s = None, None
        if want_trace:
            # the first TRACE_BATCHES batches of the set's first evaluation:
            # the same traced work in every run, timed untraced just before
            # (the profiler slows the host, and a whole evaluation's events
            # take minutes to read)
            n_traced = TRACE_BATCHES * int(tr["batch_size"])
            t_u = time.perf_counter()
            evaluate(0, n_traced)
            dev.sync(device)
            untraced_s = time.perf_counter() - t_u
            rec.take()
            _, traced = trace.traced(lambda: evaluate(0, n_traced))
            rec.take()
    finally:
        rec.remove()

    phases = {}
    for t in timers:
        for k, v in t.totals.items():
            phases[k] = phases.get(k, 0.0) + v
    n_eval = len(cycles) * n_set
    record = {
        "setup_s": setup_s, "window_s": window_s,
        "tasks": n_eval * tasks_per_eval, "batches": n_eval * n_batches,
        "peak_bytes": peak, "phases": phases, "host_syncs": syncs,
        "host_fallbacks": fallbacks,
        "batch_bound_s": work.task_batch_bound_s(
            int(tr["batch_size"]), int(tr["n_query"]), n_class,
            n_class * int(tr["shots"])),
        "auction_bound_s": work.auction_bytes(
            int(tr["batch_size"]), int(tr["n_query"]), n_class)
        / work.PEAK_BYTES_PER_S,
        "trace": traced, "trace_batches": TRACE_BATCHES if traced else 0,
        "untraced_s": untraced_s,
    }
    _say(f"window: {len(cycles)} cycles of {n_set} evaluations, "
         f"{record['tasks']} tasks in {window_s:.4f} s; host syncs {syncs}; "
         f"host-LAP fallbacks {fallbacks}; phases {phases}")

    del evaluator
    dev.free(device)
    record.update(check_outputs(cell, seed, cycles, test, train, n_batches,
                                device))
    record["failed"] = sum(
        tasks_per_eval - sum(len(b[1]) for b in ev["answers"])
        for outputs in cycles for ev in outputs)
    record["attempted"] = record["tasks"]
    return record


def cycle_order(seed, cycle, n_set):
    """The order of the set's evaluations in one cycle of the window."""
    return np.random.default_rng(
        np.random.SeedSequence([seed, 5, cycle])).permutation(n_set)


def sample_tasks(seed, n_eval, tasks_per_eval, n_check):
    """The (evaluation, task) pairs that the check solves again, drawn from
    the seed."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 11]))
    picks = rng.choice(n_eval * tasks_per_eval,
                       size=min(n_check, n_eval * tasks_per_eval),
                       replace=False)
    return sorted((int(p) // tasks_per_eval, int(p) % tasks_per_eval)
                  for p in picks)


def _distinct_rows(idx):
    """[T] whether each row of ``idx`` [T, m] holds m distinct values."""
    s = np.sort(idx, axis=1)
    return (np.diff(s, axis=1) != 0).all(axis=1)


def bad_draws(draws, prot, test_labels, train_labels, batch_size):
    """The number of recorded tasks whose draw breaks the protocol: query
    rows not n_query distinct rows of the test split, from more classes
    than a task draws (10 zero-shot, k_eff few-shot); few-shot, support rows
    not ``shots`` distinct rows of every class of the train split. A batch
    of another size counts all its tasks."""
    n_class, n_query = prot["n_class"], prot["n_query"]
    k_max = prot["k_eff"] if prot["shots"] else 10
    bad = 0
    for support, query in draws:
        if query.ndim != 2 or query.shape != (batch_size, n_query):
            bad += batch_size
            continue
        ok = _distinct_rows(query) & (query.min(1) >= 0) & (
            query.max(1) < len(test_labels))
        q_lab = np.sort(test_labels[np.clip(query, 0, len(test_labels) - 1)],
                        axis=1)
        ok &= 1 + (np.diff(q_lab, axis=1) != 0).sum(1) <= k_max
        if prot["shots"]:
            want = np.repeat(np.arange(n_class), prot["shots"])
            if support is None or support.shape != (batch_size, len(want)):
                bad += batch_size
                continue
            inside = (support.min(1) >= 0) & (
                support.max(1) < len(train_labels))
            s_lab = np.sort(train_labels[np.clip(
                support, 0, len(train_labels) - 1)], axis=1)
            ok &= inside & _distinct_rows(support) & (s_lab == want).all(1)
        bad += int((~ok).sum())
    return bad


def task_inputs(ev, t, batch_size):
    """(support rows or None, query rows) of task ``t`` of a recorded
    evaluation, or None where its draw was not recorded."""
    b, r = divmod(t, batch_size)
    if b >= len(ev["draws"]):
        return None
    support, query = ev["draws"][b]
    if query.ndim != 2 or r >= query.shape[0]:
        return None
    return (None if support is None else support[r]), query[r]


def reference_answers(cell, jobs, test, train, quant=None, device="cuda"):
    """The reference's (predictions [J, n], EM iterations [J]) of ``jobs``,
    a list of (support rows or None, query rows), in blocks of CHECK_BLOCK
    tasks, fp32 with TF32 off (``quant`` rounds the products' operands for
    the control)."""
    import torch

    ref = cell.reference()
    prot = protocol(cell.config, cell.traffic)
    opts = cell.config["reference_options"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    preds, iters = [], []
    for s in range(0, len(jobs), CHECK_BLOCK):
        block = jobs[s:s + CHECK_BLOCK]
        x = torch.as_tensor(np.stack([test[0][q] for _, q in block]),
                            device=device)
        kw = {}
        if block[0][0] is not None:
            kw = {"support": torch.as_tensor(
                np.stack([train[0][sp] for sp, _ in block]), device=device),
                "support_labels": torch.as_tensor(
                    np.stack([train[1][sp] for sp, _ in block]),
                    device=device)}
        p, it = ref.solve(x, prot, opts, quant=quant, **kw)
        preds.append(p)
        iters.append(it)
        del x, kw
    return np.concatenate(preds), np.concatenate(iters)


def compare(cfg, tr, prog_preds, prog_acc, ref_preds, labels, bad_tasks=0):
    """The numbers compared, each beside its limit, and the verdict."""
    few = int(tr["shots"]) > 0
    n_class = int(cfg["n_class"])
    if few:
        # the few-shot evaluator predicts in its flipped label space
        # (class c as n_class - 1 - c)
        prog_preds = np.where(prog_preds >= 0, n_class - 1 - prog_preds, -1)
    ref_acc = (ref_preds == labels).mean(1)
    own_acc = (prog_preds == labels).mean(1)
    limits = cfg["limits"]
    # shares, so that a limit holds at any number of checked tasks: the
    # queries whose prediction differs, the tasks whose accuracy differs
    checks = {
        "bad_tasks": {"value": int(bad_tasks), "limit": 0},
        "pred_mismatch_pct": {
            "value": 100.0 * float((prog_preds != ref_preds).mean()),
            "limit": float(limits["pred_mismatch_pct"])},
        "acc_mismatch_pct": {
            "value": 100.0 * float((np.abs(prog_acc - ref_acc) > 1e-6).mean()),
            "limit": float(limits["acc_mismatch_pct"])},
        "acc_vs_own_preds": {"value": int(np.sum(
            np.abs(prog_acc - own_acc) > 1e-6)), "limit": 0},
    }
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return checks, ok


def check_outputs(cell, seed, cycles, test, train, n_batches, device):
    """Every recorded draw against the protocol, and the sampled tasks of
    every cycle against the reference's answers on the same rows."""
    cfg, tr = cell.config, cell.traffic
    batch_size = int(tr["batch_size"])
    tasks_per_eval = n_batches * batch_size
    t0 = time.perf_counter()
    bad = bad_draws([d for outputs in cycles for ev in outputs
                     for d in ev["draws"]], protocol(cfg, tr), test[1],
                    None if train is None else train[1], batch_size)
    picks = sample_tasks(seed, len(cycles[0]), tasks_per_eval,
                         int(tr["check_tasks"]))
    jobs, where, slots = [], {}, []
    for outputs in cycles:
        for e, t in picks:
            inputs = task_inputs(outputs[e], t, batch_size)
            if inputs is None:
                slots.append(None)
                continue
            key = (e, t, inputs[1].tobytes(),
                   b"" if inputs[0] is None else inputs[0].tobytes())
            if key not in where:
                where[key] = len(jobs)
                jobs.append(inputs)
            slots.append(where[key])
    ref_preds, iters = (reference_answers(cell, jobs, test, train,
                                          device=device) if jobs
                        else (np.zeros((0, int(tr["n_query"])), np.int64),
                              np.zeros(0, np.int64)))
    n_query = int(tr["n_query"])
    prog_p, prog_a, ref_p, labels = [], [], [], []
    k = 0
    for outputs in cycles:
        for e, t in picks:
            slot = slots[k]
            k += 1
            b, r = divmod(t, batch_size)
            answers = outputs[e]["answers"]
            if b < len(answers):
                prog_p.append(answers[b][0][r])
                prog_a.append(answers[b][1][r])
            else:
                prog_p.append(np.full(n_query, -1))
                prog_a.append(np.float32(-1))
            if slot is None:
                # no draw recorded: nothing to hold the answer against
                ref_p.append(np.full(n_query, -2))
                labels.append(np.full(n_query, -3))
            else:
                ref_p.append(ref_preds[slot])
                labels.append(test[1][jobs[slot][1]])
    checks, ok = compare(cfg, tr, np.stack(prog_p), np.asarray(prog_a),
                         np.stack(ref_p), np.stack(labels), bad)
    _say(f"check: {len(picks)} sampled tasks x {len(cycles)} cycles "
         f"({len(jobs)} distinct) against the reference "
         f"({time.perf_counter() - t0:.1f} s); reference accuracy "
         f"{(np.stack(ref_p) == np.stack(labels)).mean():.6f}; reference EM "
         f"iterations a task: median {np.median(iters) if len(iters) else 0}"
         f", max {iters.max() if len(iters) else 0}")
    return {"correct": ok, "checks": checks,
            "ref_iterations": iters.tolist()}
