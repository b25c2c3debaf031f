"""North-star wall-clock artifact: ONE fresh-start training run of the port,
timed from process start, recording when the val PSNR stream crosses each
threshold — including data load, eval and checkpoint overhead
(BASELINE.json "hard400 >= 30.5 dB in < 15 min on 1 chip").

Launches `python -m nerf_pl_tpu_torch.train` as a subprocess and
timestamps every [val] line against the subprocess LAUNCH time (not
first-step time), so nothing is excluded.

    python -m nerf_pl_tpu_torch.northstar --json_out ns.json -- \
        --dataset_name blender --root_dir data/hard_blender ... (train args)

Port of scripts/northstar.py, with its flags and its regexes; the child's
Popen sits inside the try, so a signal that arrives just after it still
kills the child and writes the partial artifact.
"""
import json
import os
import re
import signal
import subprocess
import sys
import time
from argparse import ArgumentParser

VAL_RE = re.compile(r"\[val\] epoch (\d+) loss=([\d.]+) psnr=([\d.]+) "
                    r"ssim=([\d.]+)")
# Mid-epoch validation lines (--val_every_steps, the lightning
# val_check_interval analog) — finer-grained threshold timestamps.
VAL_STEP_RE = re.compile(r"\[val\] step (\d+) epoch (\d+) loss=([\d.]+) "
                         r"psnr=([\d.]+) ssim=([\d.]+)")


def main(argv=None):
    parser = ArgumentParser()
    parser.add_argument('--json_out', type=str, required=True)
    parser.add_argument('--thresholds', nargs='+', type=float,
                        default=[25.0, 30.5, 32.0, 34.0, 34.5])
    parser.add_argument('--train_script', type=str, default=None,
                        help='override the wrapped script (default: python '
                             '-m nerf_pl_tpu_torch.train; tests substitute '
                             'a stub)')
    parser.add_argument('train_args', nargs='*',
                        help='arguments forwarded to the train CLI '
                             '(after --)')
    args = parser.parse_args(argv)

    target = ([args.train_script] if args.train_script
              else ["-m", "nerf_pl_tpu_torch.train"])
    cmd = [sys.executable, *target, *args.train_args]
    print(f"[northstar] launching: {' '.join(cmd)}", flush=True)

    # `timeout`/Ctrl-C signal THIS process, not the training child — kill
    # the child (it holds the GPU; an orphan wedges every queued run
    # behind it) and still write the partial artifact via the finally
    # below: everything collected so far is real threshold data.
    # Handlers go in before Popen (no window where a signal takes the
    # default action), Popen sits inside the try (a signal right after it
    # still reaches the finally), and the handlers are reset to SIG_IGN
    # once cleanup starts so a second Ctrl-C / follow-up TERM can't
    # re-raise inside the finally and skip the child kill or the
    # partial-artifact write.
    def _terminate(signum, frame):
        raise SystemExit(128 + signum)
    prev = {s: signal.signal(s, _terminate)
            for s in (signal.SIGTERM, signal.SIGINT)}

    t0 = time.time()
    proc = None
    epochs = []
    crossed = {}
    rc = None
    result = None
    try:
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True,
                                bufsize=1)
        _pump(proc, t0, epochs, crossed, args.thresholds)
        rc = proc.wait()
    finally:
        for s in prev:
            signal.signal(s, signal.SIG_IGN)
        if proc is not None and proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
        result = _write(args.json_out, cmd, rc, time.time() - t0,
                        epochs, crossed)
        for s, h in prev.items():
            signal.signal(s, h)
    return result


def _pump(proc, t0, epochs, crossed, thresholds):
    for line in proc.stdout:
        sys.stdout.write(line)
        sys.stdout.flush()
        entry = None
        m = VAL_RE.search(line)
        ms = VAL_STEP_RE.search(line)
        if m:
            entry = {"epoch": int(m.group(1)),
                     "val_loss": float(m.group(2)),
                     "val_psnr": float(m.group(3)),
                     "val_ssim": float(m.group(4))}
        elif ms:
            entry = {"step": int(ms.group(1)), "epoch": int(ms.group(2)),
                     "val_loss": float(ms.group(3)),
                     "val_psnr": float(ms.group(4)),
                     "val_ssim": float(ms.group(5))}
        if entry:
            t = time.time() - t0
            entry["wall_s"] = round(t, 1)
            epochs.append(entry)
            for th in thresholds:
                if entry["val_psnr"] >= th and th not in crossed:
                    crossed[th] = round(t, 1)
                    print(f"[northstar] crossed {th} dB at {t/60:.2f} min "
                          f"(epoch {entry['epoch']})", flush=True)


def _write(json_out, cmd, rc, total, epochs, crossed):
    result = {
        "cmd": cmd[1:],
        "returncode": rc,   # None = killed/interrupted (partial artifact)
        "total_wall_s": round(total, 1),
        "thresholds_wall_s": {str(k): v for k, v in sorted(crossed.items())},
        "epochs": epochs,
        "best_val_psnr": max((e["val_psnr"] for e in epochs), default=None),
        "note": "wall clock measured from the train subprocess launch; "
                "includes data prep, eval and checkpoint overhead",
    }
    os.makedirs(os.path.dirname(os.path.abspath(json_out)), exist_ok=True)
    with open(json_out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"[northstar] written to {json_out}: "
          f"{result['thresholds_wall_s']}", flush=True)
    return result


if __name__ == "__main__":
    main()
