"""The multi-process launch, end to end — the port's counterpart of
``tools/multihost_dryrun.py``.

    python -m mdn_sfm_tpu_torch.multihost_dryrun --num_processes 4 --global_batch 8   # 4 cards, NCCL
    python -m mdn_sfm_tpu_torch.multihost_dryrun --device cpu                         # 2 gloo ranks, batch 4

Spawns N worker processes with the package's launch variables
(``MDN_COORDINATOR``, ``MDN_NUM_PROCESSES``, ``MDN_PROCESS_ID``,
``LOCAL_RANK``): on ``cuda`` (the default) each rank is an NCCL rank on a
card of its own, and fewer cards than ranks raises; with ``--device cpu``
each is a gloo rank on the CPU. It runs the real ``Trainer`` on synthetic
data for an epoch, then restarts all N with ``resume="auto"`` for a second
epoch, and checks the JAX tool's contract:

  (a) the manifest's per-process shards are disjoint and cover it
      (``shard_for_host``), and the ranks train on disjoint samples;
  (b) after training, the params are bitwise equal on every rank;
  (c) rank 0 alone writes checkpoints;
  (d) the restart re-enters at the interrupted step and completes the run.

Prints one JSON line; exits 0 only if every check holds.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import socket
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --------------------------------------------------------------------- worker


def worker_main(args) -> None:
    import torch

    from . import checkpoints as ckpt
    from .config import Config
    from .parallel import (maybe_initialize_distributed, process_count, process_device, process_index,
                           shutdown_distributed)
    from .trainer import Trainer

    if not maybe_initialize_distributed(args.device):
        raise SystemExit("worker launched without the MDN_* environment")
    try:
        rank, world = process_index(), process_count()
        writes: list[str] = []  # check (c)
        real_save = ckpt.save_checkpoint

        def counting_save(folder, *a, **kw):
            writes.append(os.path.basename(folder))
            return real_save(folder, *a, **kw)

        ckpt.save_checkpoint = counting_save
        cfg = Config(height=args.height, width=args.width, batch_size=args.global_batch,
                     num_epochs=args.num_epochs, limit_train_samples=args.num_samples, num_workers=1,
                     save_frequency=10_000,  # only the end-of-train checkpoint
                     log_frequency=1000, compute_dtype="float32", resume="auto" if args.resume else "",
                     log_dir=os.path.join(args.work_dir, "log"), other_files_path=os.path.join(args.work_dir, "files"),
                     v_save="mh", w_d2_sim=0.0).validate()
        trainer = Trainer(cfg, synthetic=True, device=process_device(args.device))
        trainer.train()
        digest = hashlib.sha256()
        for net, module in zip(("flownet", "posenet", "mobile_decoder"), trainer.models):
            for key, value in sorted(module.state_dict().items()):
                digest.update(f"{net}.{key}".encode())
                digest.update(value.detach().cpu().contiguous().numpy().tobytes())
        ids = trainer.train_loader.dataset.indices if world > 1 else range(len(trainer.train_loader.dataset))
        result = {
            "process_index": rank,
            "process_count": world,
            "steps_per_epoch": trainer.steps_per_epoch,
            "start_step": trainer.start_step,
            "final_step": trainer.step,
            "adam_count": trainer.opt.count,
            "params_sha256": digest.hexdigest(),
            "checkpoint_writes": writes,
            "local_dataset_len": len(trainer.train_loader.dataset),
            "trained_samples": sorted({int(ids[i]) for _, idx in trainer.sample_history for i in idx}),
            "torch_threads": torch.get_num_threads(),
        }
        with open(os.path.join(args.work_dir, f"result_{args.phase}_{rank}.json"), "w") as f:
            json.dump(result, f)
        print(f"[worker {rank}] done: {result}", flush=True)
    finally:
        shutdown_distributed()


# ------------------------------------------------------------------- launcher


def check_manifest_sharding(host_count: int) -> dict:
    """Check (a): the shards of the eigen_zhou train manifest are disjoint,
    of equal length, and cover it but for fewer than ``host_count`` lines."""
    from .data.splits import read_split_lines, repo_root, shard_for_host, split_path

    lines = read_split_lines(split_path(repo_root(), "eigen_zhou", "train"))
    shards = [shard_for_host(lines, h, host_count) for h in range(host_count)]
    union = set().union(*(set(s) for s in shards))
    dropped = len(set(lines)) - len(union)
    ok = (len(union) == sum(len(s) for s in shards) and 0 <= dropped < host_count
          and len({len(s) for s in shards}) == 1)
    return {"ok": ok, "manifest_lines": len(lines), "per_host": len(shards[0]), "dropped": dropped}


def launch_phase(args, phase: str, num_epochs: int, resume: bool) -> list[dict]:
    """Run the N workers of one phase to their end; their results by rank."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for pid in range(args.num_processes):
        env = dict(os.environ, MDN_COORDINATOR=f"127.0.0.1:{port}", MDN_NUM_PROCESSES=str(args.num_processes),
                   MDN_PROCESS_ID=str(pid), LOCAL_RANK=str(pid), OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(filter(None, [REPO, os.environ.get("PYTHONPATH")])))
        for key in ("RANK", "WORLD_SIZE"):
            env.pop(key, None)
        cmd = [sys.executable, "-m", "mdn_sfm_tpu_torch.multihost_dryrun", "--worker", "--phase", phase,
               "--work_dir", args.work_dir, "--device", args.device, "--global_batch", str(args.global_batch),
               "--num_samples", str(args.num_samples), "--num_epochs", str(num_epochs),
               "--height", str(args.height), "--width", str(args.width)] + (["--resume"] if resume else [])
        log = open(os.path.join(args.work_dir, f"worker_{phase}_{pid}.log"), "w")
        procs.append((subprocess.Popen(cmd, env=env, stdout=log, stderr=subprocess.STDOUT), log))
    try:
        for pid, (p, log) in enumerate(procs):
            rc = p.wait(timeout=args.timeout)
            log.close()
            if rc != 0:
                with open(os.path.join(args.work_dir, f"worker_{phase}_{pid}.log")) as f:
                    raise RuntimeError(f"worker {pid} of phase {phase} exited {rc}:\n{f.read()[-4000:]}")
    finally:
        for p, log in procs:  # a failed or hung worker takes the others down
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    results = []
    for pid in range(args.num_processes):
        with open(os.path.join(args.work_dir, f"result_{phase}_{pid}.json")) as f:
            results.append(json.load(f))
    return results


def launcher_main(args) -> None:
    n = args.num_processes
    if n < 2:
        raise SystemExit("--num_processes: a process group needs at least 2 ranks")
    if args.device == "cuda":
        import torch

        cards = torch.cuda.device_count()
        if cards < n:
            raise SystemExit(f"--device cuda runs one rank a card: {n} ranks need {n} cards, this host has "
                             f"{cards} (--device cpu runs gloo ranks on the CPU)")
    args.work_dir = args.work_dir or tempfile.mkdtemp(prefix="mdn_multihost_")
    os.makedirs(args.work_dir, exist_ok=True)
    manifest = check_manifest_sharding(n)
    a = launch_phase(args, "fresh", num_epochs=1, resume=False)
    b = launch_phase(args, "resume", num_epochs=2, resume=True)
    steps = a[0]["steps_per_epoch"]
    trained = [set(r["trained_samples"]) for r in a]
    checks = {
        "manifest_disjoint_complete": manifest["ok"],
        "ranks_trained_on_disjoint_samples": sum(map(len, trained)) == len(set().union(*trained)),
        "params_bitwise_identical_fresh": len({r["params_sha256"] for r in a}) == 1,
        "params_bitwise_identical_resume": len({r["params_sha256"] for r in b}) == 1,
        "only_process0_writes": all((len(r["checkpoint_writes"]) > 0) == (r["process_index"] == 0) for r in a + b),
        "resume_reentered_at_step": all(r["start_step"] == steps for r in b),
        "resume_completed": all(r["final_step"] == r["adam_count"] == 2 * steps for r in b),
        "fresh_completed": all(r["final_step"] == r["adam_count"] == steps for r in a),
        "group_spans_all_processes": all(r["process_count"] == n for r in a + b),
        "hosts_fed_disjoint_slices": all(r["local_dataset_len"] == args.num_samples // n for r in a + b),
    }
    ok = all(checks.values())
    print(json.dumps({"ok": ok, "device": args.device, "num_processes": n, "global_batch": args.global_batch,
                      "steps_per_epoch": steps, "checks": checks, "manifest": manifest, "work_dir": args.work_dir}))
    raise SystemExit(0 if ok else 1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--worker", action="store_true", help="run as one rank (the launcher passes it)")
    ap.add_argument("--phase", default="fresh")
    ap.add_argument("--work_dir", default="")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: NCCL, one card a rank (the default); cpu: gloo")
    ap.add_argument("--num_processes", type=int, default=2)
    ap.add_argument("--global_batch", type=int, default=4)
    ap.add_argument("--num_samples", type=int, default=16)
    ap.add_argument("--num_epochs", type=int, default=1)
    ap.add_argument("--height", type=int, default=32)
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--timeout", type=int, default=1200, help="seconds a phase's workers may take")
    args = ap.parse_args(argv)
    if args.worker:
        worker_main(args)
    else:
        launcher_main(args)


if __name__ == "__main__":
    main()
