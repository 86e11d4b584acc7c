#!/usr/bin/env python
"""The convergence soak of the PyTorch port, with a real preemption: the
port's tool for the JAX package's soak recipes (``configs/soak_onechip.yaml``,
``configs/soak_fused_r5.yaml``).

It writes the structured synthetic corpus at the recipe's shapes
(``data/synthetic.write_synthetic_corpus(..., structured=True)``: 4 shards
of 16 records), starts ``scripts/pretrain_torch.py`` on it as a
subprocess with the recipe's command line, sends it SIGTERM once it has
logged the step ``--preempt_at`` minus the log delay (so it stops about
``--preempt_at``), checks that it exits with 0 after writing its checkpoint
and the loader's sidecar, and restarts the same command, which resumes and
finishes. Then it prints the 50-step windowed means of the three loss
terms over the whole run, the steps per second on both sides of the
preemption, the checkpoint's write and load seconds, and the peak device
memory, with the card's name and power limit, and one JSON line.

    python3 scripts/profile_torch_soak.py --config soak_onechip
    python3 scripts/profile_torch_soak.py --config soak_fused_r5

Full ``base`` widths on the card by default; ``--steps``, ``--preempt_at``
and ``--records`` shorten it, ``--device cpu`` with a small YAML config is a
smoke run.
"""

import argparse
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# the recipes' command lines (the configs' header comments)
RECIPES = {"soak_onechip": dict(preempt_at=753, flags=[]),
           "soak_fused_r5": dict(preempt_at=755,
                                 flags=["-batch_size", "2", "--fused_data", "--on_device_frames"])}
TERMS = ("stuff_to_span", "text_to_audio", "imgs_to_audio")
WINDOW = 50
TIMEOUT_S = 3000  # per process
_STEP = re.compile(r"^step (\d+): (.*)$")
_RATE = re.compile(r"^steps (\d+)\.\.(\d+): ([0-9.]+)s \(([0-9.]+) it/s\)$")


def parse_log(text):
    """From pretrain_torch.py's output: {step: {term: loss}}, the 100-step
    rate lines [(first, last, seconds)], and the resume's, the final
    save's and the peak's numbers where printed, with ``-log_batches`` the
    batches' digests ({step: (records, built)} under "batches")."""
    losses, rates, out = {}, [], {"batches": {}}
    for line in text.splitlines():
        m = re.match(r"^batch (\d+): records (\w+) built (\w+)$", line)
        if m:
            out["batches"][int(m.group(1))] = (m.group(2), m.group(3))
        m = _STEP.match(line)
        if m and "=" in m.group(2):
            losses[int(m.group(1))] = {k: float(v) for k, v in
                                      (kv.split("=") for kv in m.group(2).split())}
        m = _RATE.match(line)
        if m:
            rates.append((int(m.group(1)), int(m.group(2)), float(m.group(3))))
        m = re.match(r"^resumed from step (\d+) \((\w+)\) in ([0-9.]+) s$", line)
        if m:
            out["resumed_step"], out["load_s"] = int(m.group(1)), float(m.group(3))
        m = re.match(r"^checkpoint of step (\d+) written in ([0-9.]+) s$", line)
        if m:
            out["saved_step"], out["write_s"] = int(m.group(1)), float(m.group(2))
        m = re.match(r"^peak device memory ([0-9.]+) GiB$", line)
        if m:
            out["peak_gib"] = float(m.group(1))
    return losses, rates, out


def tracked_losses(output_dir):
    """{step: {term: loss}} at full precision from a run's tracker
    (``<output_dir>/run/metrics.jsonl``; a preempted process and its
    resumption append to the same file)."""
    with open(os.path.join(output_dir, "run", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    return {r["step"]: {k: r[k] for k in (*TERMS, "total")} for r in rows if "total" in r}


def windowed_means(losses, window=WINDOW):
    """[(first, last + 1, {term: mean})] over consecutive windows of steps."""
    rows = []
    steps = sorted(losses)
    for start in range(0, (steps[-1] + 1) if steps else 0, window):
        inside = [losses[s] for s in steps if start <= s < start + window]
        if inside:
            rows.append((start, start + window,
                         {t: sum(x[t] for x in inside) / len(inside) for t in TERMS}))
    return rows


def steps_per_s(rates, resumed_at=None):
    """Steps per second of each process's 100-step blocks, leaving out its
    first block (start-up, and after a resume a partial block)."""
    kept = rates[1:]
    if resumed_at is not None:
        kept = [r for r in kept if r[0] > resumed_at + 1]
    return [(last - first + 1) / s for first, last, s in kept]


def run_process(cmd, signal_after=None, timeout=TIMEOUT_S):
    """Run ``cmd`` (``scripts/pretrain_torch.py``) to its end; with
    ``signal_after``, SIGTERM it once it has logged that step or a later
    one. (exit code, output, seconds, seconds from the signal to the exit
    or None)."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            cwd=REPO)
    lines, sent = [], None
    deadline = time.time() + timeout
    try:
        for line in proc.stdout:
            lines.append(line.rstrip("\n"))
            m = _STEP.match(line)
            if signal_after is not None and sent is None and m and int(m.group(1)) >= signal_after:
                proc.send_signal(signal.SIGTERM)
                sent = time.perf_counter()
            if time.time() > deadline:
                raise RuntimeError(f"{os.path.basename(cmd[1])} ran past {timeout} s")
        code = proc.wait(timeout=max(deadline - time.time(), 1))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    end = time.perf_counter()
    return code, "\n".join(lines), end - t0, None if sent is None else end - sent


def preempt_and_resume(cmd, out, signal_after, timeout=TIMEOUT_S, resume_cmd=None):
    """The soak's preemption: ``cmd`` gets SIGTERM once it logs step
    ``signal_after``, must exit with 0 leaving ``ckpt_<n>`` and
    ``loader_state.json`` in ``out``, and the same command (or
    ``resume_cmd(n)``, the same run with fewer steps) must resume at step n,
    log step n first and exit with 0. Returns {"first", "second":
    the two outputs, "stopped": n, "checkpoints": the ckpt_ steps after the
    SIGTERM, "sidecar", "first_s", "exit_s": from the signal to the exit,
    "second_s"}; raises RuntimeError where a step of it failed."""
    code, first, first_s, exit_s = run_process(cmd, signal_after, timeout)
    if code != 0 or exit_s is None:
        raise RuntimeError(f"the preempted process exited with {code} (SIGTERM sent: "
                           f"{exit_s is not None}):\n{first[-4000:]}")
    stopped = sorted(int(n[5:]) for n in os.listdir(out) if re.match(r"^ckpt_\d+$", n))
    sidecar_path = os.path.join(out, "loader_state.json")
    if not stopped or not os.path.isfile(sidecar_path):
        raise RuntimeError(f"no checkpoint and sidecar after the SIGTERM: {os.listdir(out)}")
    with open(sidecar_path) as f:
        sidecar = json.load(f)
    resumed = cmd if resume_cmd is None else resume_cmd(max(stopped))
    code, second, second_s, _ = run_process(resumed, timeout=timeout)
    if code != 0:
        raise RuntimeError(f"the resumed process exited with {code}:\n{second[-4000:]}")
    (_, _, o1), (l2, _, o2) = parse_log(first), parse_log(second)
    n = o1.get("saved_step")
    if not (n == stopped[-1] == o2.get("resumed_step") and l2 and min(l2) == n):
        raise RuntimeError(f"preempted at {n}, checkpoints {stopped}, resumed at "
                           f"{o2.get('resumed_step')}, first resumed step {min(l2, default=None)}")
    return {"first": first, "second": second, "stopped": n, "checkpoints": stopped,
            "sidecar": sidecar, "first_s": first_s, "exit_s": exit_s, "second_s": second_s}


def _card():
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "not measured"
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "not measured"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="soak_onechip", help="a recipe name or a YAML path")
    ap.add_argument("--recipe", default=None, choices=sorted(RECIPES),
                    help="the command line of this recipe (default: --config's name)")
    ap.add_argument("--steps", type=int, default=None, help="default the recipe's 1200")
    ap.add_argument("--preempt_at", type=int, default=None)
    ap.add_argument("--records", type=int, default=16, help="records per shard")
    ap.add_argument("--log_every", type=int, default=50,
                    help="the loop's metrics delay: a step is printed this many steps late")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workdir", default=None, help="default a temporary directory")
    args = ap.parse_args(argv)

    from merlot_reserve_tpu_torch import load_config
    from merlot_reserve_tpu_torch.data.synthetic import write_synthetic_corpus
    from merlot_reserve_tpu_torch.utils.device import resolve_device

    resolve_device(args.device)  # the card unless asked otherwise, before any work
    recipe = RECIPES[args.recipe or os.path.splitext(os.path.basename(args.config))[0]]
    cfg = load_config(args.config)
    steps = args.steps or cfg.optimizer.num_train_steps
    preempt_at = args.preempt_at or recipe["preempt_at"]
    work = args.workdir or tempfile.mkdtemp(prefix="soak_")
    data, out = os.path.join(work, "data"), os.path.join(work, "out")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(data, exist_ok=True)
    t0 = time.perf_counter()
    for i in range(cfg.data.num_train_files):
        write_synthetic_corpus(os.path.join(data, f"fold{i:05d}.tfrecord"), cfg,
                               num_records=args.records, seed=i, structured=True)
    corpus_s = time.perf_counter() - t0
    cmd = [sys.executable, os.path.join(REPO, "scripts", "pretrain_torch.py"), args.config,
           "-train_fns", os.path.join(data, "fold{:05d}.tfrecord"), "-output_dir", out,
           "-num_steps", str(steps), "-seed", "0", "-log_every", str(args.log_every),
           "--device", args.device] + recipe["flags"]
    print(f"[soak] {' '.join(cmd[1:])}", flush=True)

    # the first process: SIGTERM once it has logged step preempt_at - log_every - 1
    signal_after = max(preempt_at - args.log_every - 1, 0)
    run = preempt_and_resume(cmd, out, signal_after)
    sidecar, exited_s, n = run["sidecar"], run["exit_s"], run["stopped"]
    l1, r1, o1 = parse_log(run["first"])
    l2, r2, o2 = parse_log(run["second"])
    losses = {**{s: v for s, v in l1.items() if s < n}, **l2}
    missing = sorted(set(range(steps)) - set(losses))
    if missing:
        raise SystemExit(f"no losses logged for steps {missing[:10]}...")
    rows = windowed_means(losses)
    before, after = steps_per_s(r1), steps_per_s(r2, resumed_at=n)
    card = _card()
    print(f"[soak] {card}: {args.config}, {steps} steps, SIGTERM after step {signal_after}'s "
          f"log, stopped at step {n} ({exited_s:.1f} s after the signal), resumed at step "
          f"{o2['resumed_step']}; corpus {corpus_s:.1f} s", flush=True)
    print(f"[soak] checkpoint write {o1['write_s']:.2f} s, load {o2['load_s']:.2f} s; "
          f"peak device memory {o1.get('peak_gib')} / {o2.get('peak_gib')} GiB", flush=True)
    print(f"[soak] steps/s before the preemption {[round(x, 3) for x in before]}, after "
          f"{[round(x, 3) for x in after]}", flush=True)
    print("| steps | " + " | ".join(TERMS) + " |")
    print("|---|" + "---|" * len(TERMS))
    for a, b, means in rows:
        mark = " (preempted inside)" if a < n < b else ""
        print(f"| {a}-{b}{mark} | " + " | ".join(f"{means[t]:.4f}" for t in TERMS) + " |")
    print(json.dumps({"config": args.config, "steps": steps, "card": card, "preempted_at": n,
                      "loader_state": sidecar, "windows": rows, "steps_per_s_before": before,
                      "steps_per_s_after": after, "write_s": o1["write_s"],
                      "load_s": o2["load_s"], "peak_gib": [o1.get("peak_gib"),
                                                           o2.get("peak_gib")],
                      "first_losses": [losses[s] for s in range(min(11, steps))]}), flush=True)
    if not args.workdir:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
