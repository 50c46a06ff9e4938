"""Elastic training worker for the launcher-driven tests of the port
(``tests/test_torch_elastic.py``, ``tests/test_torch_preemption.py``):
run as ``python -m horovod_tpu_torch.run -np N [--elastic] -- python
tests/_torch_elastic_train_script.py`` on gloo.

Gradients are deterministic, rank-independent and dyadic with few bits
(``round(16 (w - target)) / 16``), so the world's average is exact at
any world size and the final parameters equal :func:`closed_form` bit
for bit, whatever trajectory of world sizes the job took.

Knobs (environment): ``ELX_TOTAL`` steps; ``ELX_KILL_UID`` and
``ELX_KILL_STEP``: the process with that elastic uid SIGKILLs itself at
that step boundary, once its peers reached it (a key on the launcher's
KV store); ``ELX_NOTICE_UID`` and ``ELX_NOTICE_STEP``: that process
SIGTERMs itself after that step (a preemption notice);
``ELX_EAGER=1``: one eager allreduce per step (a negotiated round);
``ELX_GROW_AT``: a world below the launched size holds at that step,
committing, until the launcher's joiner is admitted;
``ELX_COMMIT_EVERY``; ``ELX_STEP_SLEEP``.  Each rank prints JSON lines:
``{"event": "interrupt", ...}`` where it left the loop for a re-form or
a drain, ``{"event": "recut", ...}`` after a re-form at ZeRO stage 1-3
(the shard state gathered against the commit), and a last ``{"event":
"final", ...}``.
"""

import json
import os
import signal
import sys
import time

import numpy as np
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import elastic
from horovod_tpu_torch.runtime import preemption

N = 4
LR, MOMENTUM = 0.125, 0.5
TARGET = torch.arange(1.0, 1.0 + N)


def grad(w: torch.Tensor) -> torch.Tensor:
    return torch.round((w - TARGET) * 16) / 16


def closed_form(total: int) -> list:
    """The parameters after ``total`` steps on one process."""
    w = torch.zeros(N, requires_grad=True)
    opt = torch.optim.SGD([w], lr=LR, momentum=MOMENTUM)
    for _ in range(total):
        w.grad = grad(w.detach())
        opt.step()
    return w.detach().tolist()


def emit(**rec) -> None:
    print(json.dumps(rec, sort_keys=True), flush=True)


def main() -> int:
    hvd.init()
    uid = os.environ.get("HOROVOD_ELASTIC_UID", "")
    total = int(os.environ.get("ELX_TOTAL", "10"))
    every = int(os.environ.get("ELX_COMMIT_EVERY", "1"))
    kill_uid = os.environ.get("ELX_KILL_UID", "")
    kill_step = int(os.environ.get("ELX_KILL_STEP", "-1"))
    notice_uid = os.environ.get("ELX_NOTICE_UID", "")
    notice_step = int(os.environ.get("ELX_NOTICE_STEP", "-1"))
    sleep_s = float(os.environ.get("ELX_STEP_SLEEP", "0"))
    eager = os.environ.get("ELX_EAGER") == "1"
    grow_at = int(os.environ.get("ELX_GROW_AT", "-1"))
    full = int(os.environ.get("HOROVOD_ELASTIC_NP", "0") or 0)
    from horovod_tpu_torch.optim import distributed as D

    w = torch.nn.Parameter(torch.zeros(N))
    zero3 = int(os.environ.get("HOROVOD_ZERO_STAGE", "0") or 0) >= 3
    if zero3:
        # the parameters live as shards; the state holds their
        # Zero3Params, read back from state.params after every restore
        params = {"zp": D.zero3_shard_params({"w": w})}
        opt = hvd.DistributedOptimizer(torch.optim.SGD(
            params["zp"].shards, lr=LR, momentum=MOMENTUM))
    else:
        params = {"w": w}
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD([w], lr=LR, momentum=MOMENTUM))
    state = elastic.ElasticState(params=params, opt_state=opt, step=0)

    def current():
        if zero3:
            return D.zero3_full_params(state.params["zp"])["w"]
        return w

    def train(state):
        emit(event="enter", uid=uid, rank=hvd.rank(), size=hvd.size(),
             gen=elastic.generation(), step=state.step)
        while state.step < total:
            try:
                if state.step % every == 0:
                    state.commit()
                elastic.poll()
            except (elastic.HostsUpdatedInterrupt,
                    preemption.PreemptionInterrupt) as exc:
                emit(event="interrupt", kind=type(exc).__name__, uid=uid,
                     rank=hvd.rank(), gen=elastic.generation(),
                     step=state.step, commits=state.commits)
                raise
            if state.step == grow_at and hvd.size() < full:
                # hold the world at this step, committing, until the
                # launcher's joiner is admitted (or a minute passes)
                deadline = time.monotonic() + 60
                while time.monotonic() < deadline:
                    try:
                        state.commit()
                    except elastic.HostsUpdatedInterrupt as exc:
                        emit(event="interrupt", kind=type(exc).__name__,
                             uid=uid, rank=hvd.rank(),
                             gen=elastic.generation(), step=state.step,
                             commits=state.commits)
                        raise
                    elastic.poll()
                    time.sleep(0.1)
            if kill_uid and state.step == kill_step \
                    and elastic.generation() == 1:
                # die at a step boundary once every peer reached it: the
                # peers then wait on the dead rank in this step's
                # allreduce
                t = elastic._rv()
                t.set_overwrite(f"elx/at/{hvd.rank()}", "1")
                if uid == kill_uid:
                    for r in range(hvd.size()):
                        elastic._bounded_get(t, f"elx/at/{r}", 60.0)
                    emit(event="dying", uid=uid, step=state.step)
                    os.kill(os.getpid(), signal.SIGKILL)
            if eager:
                # one negotiated round per step (the rounds a preempt:
                # fault rule counts)
                hvd.allreduce(torch.ones(1), name="elx.tick")
            if zero3:
                opt.zero_grad()
                wf = current()
                # d/dwf of sum(wf * g) is g: the shard gradients are
                # the world's sum of it, averaged by the tail
                (wf * grad(wf.detach())).sum().backward()
            else:
                w.grad = grad(w.detach())
            opt.step()
            state.step += 1
            if uid == notice_uid and state.step == notice_step:
                os.kill(os.getpid(), signal.SIGTERM)
            if sleep_s:
                time.sleep(sleep_s)
        state.commit()
        return state

    orig_restore = elastic.ElasticState.restore

    def restore_and_check(self):
        orig_restore(self)
        if opt.zero_stage >= 1 and self._commit is not None:
            # the re-cut state, gathered again, against the commit
            (kind, host), = elastic._opt_to_host(opt).items()
            commit = self._commit["opt_state"][kind]
            same = True
            for gi, (now, then) in enumerate(zip(host.inner,
                                                 commit.inner)):
                total_g = sum(host.layout.sizes[gi])
                for k, v in then.items():
                    if isinstance(v, np.ndarray):
                        same &= bool(np.array_equal(
                            np.asarray(now[k])[:total_g], v[:total_g]))
            emit(event="recut", uid=uid, rank=hvd.rank(), size=hvd.size(),
                 same=same, padded=list(host.layout.padded))

    elastic.ElasticState.restore = restore_and_check
    elastic.run(state, train)
    st = elastic.stats()
    emit(event="final", uid=uid, rank=hvd.rank(), size=hvd.size(),
         gen=elastic.generation(), step=state.step, reforms=st["reforms"],
         params=[float(x) for x in current().detach().tolist()],
         closed=closed_form(total))
    hvd.shutdown()
    return 0


# ---------------------------------------------------------------------------
# The four-card scenario (tests/test_torch_cuda.py::
# test_four_cards_elastic_resnet50)
# ---------------------------------------------------------------------------

GEN_STEPS = 4   # training steps per generation


def _smi_apps() -> tuple:
    """``nvidia-smi``'s compute processes as ``[pid, card uuid]`` pairs,
    and the cards as ``{index: uuid}``."""
    import subprocess

    def query(*args):
        out = subprocess.run(["nvidia-smi", *args, "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30,
                             check=True).stdout
        return [[f.strip() for f in ln.split(",")]
                for ln in out.splitlines() if ln.strip()]

    apps = [[int(pid), uuid] for pid, uuid in
            query("--query-compute-apps=pid,gpu_uuid")]
    cards = {int(i): uuid for i, uuid in query("--query-gpu=index,uuid")}
    return apps, cards


def cards_main() -> int:
    """The ResNet-50 bench step (224 px, batch 256 per card, bf16, fused
    momentum SGD, in-trace ZeRO stage 2, deterministic cuDNN) through
    four generations, a commit every step: generation 1 takes
    GEN_STEPS steps, then rank 0 runs ``python -m horovod_tpu_torch.run
    --preempt 3`` from inside the job; generation 2 (rank 3 drained)
    takes GEN_STEPS steps and waits at its commits for the launcher's
    joiner; generation 3 (grown back) takes GEN_STEPS steps, then the
    process at rank 2 SIGKILLs itself after the commit of its last step;
    generation 4 takes GEN_STEPS
    steps and finishes.  A generation that has taken its steps keeps
    committing and polling until the next event.  At each generation's
    start rank 0 reads ``nvidia-smi``'s compute processes.
    ``ELX_CARDS=clean`` is the control instead: ``ELX_TOTAL`` steps and
    no event, a commit and a poll before every step, under ``--elastic``
    or without it.  ``ELX_DEVICE=cpu`` rehearses either on gloo (with
    the models patched small)."""
    import hashlib
    import subprocess

    device = os.environ.get("ELX_DEVICE", "cuda")
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    hvd.init(device=None if device == "cuda" else device)
    from horovod_tpu_torch.models.resnet import ResNet50
    from horovod_tpu_torch.ops import batch_norm as BN
    from horovod_tpu_torch.optim import distributed as D
    from horovod_tpu_torch.optim import fused_update as TF
    from horovod_tpu_torch.train_step import synthetic_batch, train_step

    uid = os.environ.get("HOROVOD_ELASTIC_UID", "")
    model = ResNet50(num_classes=1000, dtype=torch.bfloat16, seed=0)
    opt = hvd.DistributedOptimizer(
        hvd.fused_update.sgd(model.parameters(), 0.1, momentum=0.9),
        zero_stage=2)
    images, labels = synthetic_batch(256, 224, 1000, seed=0)
    state = elastic.ElasticState(params=model, opt_state=opt, step=0)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    real_reform = elastic._reform

    def reform(state, dead=(), reason="failure"):
        emit(event="reform_start", uid=uid, reason=reason,
             dead=sorted(int(r) for r in dead), t=time.time())
        return real_reform(state, dead=dead, reason=reason)

    elastic._reform = reform

    def digest() -> str:
        h = hashlib.sha256()
        for v in model.state_dict().values():
            h.update(v.detach().float().cpu().numpy().tobytes())
        host = D.sharded_state_to_host(opt)   # the gathered trace
        for st in host.inner:
            for k in sorted(st):
                if isinstance(st[k], np.ndarray):
                    h.update(st[k].tobytes())
        return h.hexdigest()

    def counts() -> dict:
        return {"b1": TF.LAUNCHES["momentum"],
                "bn": {k: v for k, v in BN.LAUNCHES.items()}}

    def clean(state):
        total = int(os.environ.get("ELX_TOTAL", "10"))
        while state.step < total:
            t0 = time.perf_counter()
            state.commit()
            commit_s = time.perf_counter() - t0
            elastic.poll()
            TF.reset_launch_counts()
            BN.reset_launch_counts()
            t = time.perf_counter()
            loss = float(train_step(model, opt, images, labels))
            sync()
            state.step += 1
            now = time.perf_counter()
            emit(event="step", uid=uid, rank=hvd.rank(), step=state.step,
                 loss=loss, step_s=now - t, commit_s=commit_s,
                 iter_s=now - t0, elastic=elastic.enabled(), **counts())
        return state

    def train(state):
        gen = elastic.generation()
        smi = (_smi_apps() if device == "cuda" and hvd.rank() == 0
               else None)
        emit(event="enter", uid=uid, rank=hvd.rank(), size=hvd.size(),
             gen=gen, step=state.step, pid=os.getpid(),
             device=str(next(model.parameters()).device),
             current=(torch.cuda.current_device() if device == "cuda"
                      else -1), digest=digest(), smi=smi, t=time.time())
        taken, preempt_sent = 0, False
        while True:
            state.commit()
            elastic.poll()
            if taken >= GEN_STEPS:
                if gen >= 4:
                    return state
                if gen == 3 and hvd.rank() == 2:
                    # after its last step and the commit of it
                    emit(event="dying", uid=uid, step=state.step,
                         t=time.time())
                    os.kill(os.getpid(), signal.SIGKILL)
                if gen == 1 and hvd.rank() == 0 and not preempt_sent:
                    preempt_sent = True
                    out = subprocess.run(
                        [sys.executable, "-m", "horovod_tpu_torch.run",
                         "--preempt", "3"], capture_output=True, text=True,
                        timeout=60)
                    emit(event="preempt_sent", rc=out.returncode,
                         err=out.stderr[-300:], t=time.time())
                time.sleep(0.2)
                continue
            TF.reset_launch_counts()
            BN.reset_launch_counts()
            t = time.perf_counter()
            loss = float(train_step(model, opt, images, labels))
            sync()
            taken += 1
            state.step += 1
            emit(event="step", uid=uid, rank=hvd.rank(), size=hvd.size(),
                 gen=gen, step=state.step, loss=loss,
                 step_s=time.perf_counter() - t, t=time.time(),
                 **counts())

    fn = clean if os.environ["ELX_CARDS"] == "clean" else train
    if elastic.enabled():
        elastic.run(state, fn)
    else:
        fn(state)   # the control's launch without --elastic
    emit(event="final", uid=uid, rank=hvd.rank(), size=hvd.size(),
         gen=elastic.generation(), step=state.step, digest=digest(),
         stats=elastic.stats())
    hvd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(cards_main() if os.environ.get("ELX_CARDS") in ("1", "clean")
             else main())
