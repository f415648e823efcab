"""Rank bodies of tests/test_torch_port_parallel.py and
tests/test_torch_port_sequence_parallel.py.

Each rank is a process of its own that imports torch, numpy and
dvc_tpu_torch only (never jax: the tests' processes hold both), joins a
gloo group through a file store in the test's temporary directory, runs
one scenario on the inputs the test saved there, and saves its results for
the test to hold against dvc_tpu:

    python tests/torch_parallel_ranks.py <scenario> <rank> <world> <dir>

``Ranks`` starts the ranks from a test and waits for them within a
deadline; init_process_group has its own timeout, so a hung collective
fails the test instead of stalling the suite.
"""

from __future__ import annotations

import datetime
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
COLLECTIVE_TIMEOUT_S = 60


class Ranks:
    """``world`` rank processes running ``scenario`` on ``inputs``, started
    at once; ``results`` waits for them within ``timeout`` seconds of the
    start, so a test can compute its reference while they run."""

    def __init__(self, scenario: str, world: int, workdir: Path, inputs: dict,
                 timeout: float = 150.0):
        self.scenario, self.world, self.workdir = scenario, world, workdir
        workdir.mkdir(parents=True, exist_ok=True)
        torch.save(inputs, workdir / "inputs.pt")
        env = {**os.environ, "OMP_NUM_THREADS": "1",
               "PYTHONPATH": os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")])}
        self.logs = [open(workdir / f"rank{r}.log", "w") for r in range(world)]
        self.procs = [subprocess.Popen([sys.executable, __file__, scenario, str(r), str(world),
                                        str(workdir)], env=env, stdout=self.logs[r],
                                       stderr=subprocess.STDOUT) for r in range(world)]
        self.deadline = time.monotonic() + timeout
        self.timeout = timeout

    def results(self) -> list[dict]:
        """Each rank's results in rank order.  Fails, with the ranks' logs,
        when a rank fails or the ranks are not done by the deadline."""
        failed = None
        try:
            for r, p in enumerate(self.procs):
                try:
                    if p.wait(timeout=max(self.deadline - time.monotonic(), 0.1)) != 0:
                        failed = f"rank {r} exited {p.returncode}"
                        break
                except subprocess.TimeoutExpired:
                    failed = f"ranks not done within {self.timeout} s"
                    break
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for f in self.logs:
                f.close()
        if failed:
            tails = "\n".join(f"--- rank {r}\n{(self.workdir / f'rank{r}.log').read_text()[-3000:]}"
                              for r in range(self.world))
            raise AssertionError(f"{self.scenario}: {failed}\n{tails}")
        return [torch.load(self.workdir / f"rank{r}.pt", weights_only=False)
                for r in range(self.world)]


# -- scenarios -------------------------------------------------------------------

def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _group_rows(x: np.ndarray, groups: int, dp: int, r: int) -> np.ndarray:
    """Rank r's rows of a batch of ``groups`` stacked groups, each split
    over dp ranks: the rows of every group, stacked (a pair-fused pass's
    layout on each rank)."""
    b = x.shape[0]
    return x.reshape(groups, dp, b // (groups * dp), *x.shape[1:])[:, r].reshape(
        -1, *x.shape[1:])


def _full_grads(model, mesh, placements) -> dict[str, torch.Tensor]:
    """Each parameter's gradient, whole (model-sharded ones gathered)."""
    from dvc_tpu_torch.parallel.collectives import gather_blocks
    from dvc_tpu_torch.parallel.mesh import Shard
    out = {}
    for n, p in model.named_parameters():
        tp = placements[n][1]
        g = p.grad
        out[n] = gather_blocks(g, tp.dim, mesh.model_group) if isinstance(tp, Shard) else g
    return {n: g.clone() for n, g in out.items()}


def _mean_terms(terms, mesh) -> list[float]:
    import torch.distributed as dist
    v = torch.stack(list(terms)).double()
    dist.all_reduce(v, group=mesh.data_group)
    return (v / mesh.dp).tolist()


def _injected_step(tr, inp) -> dict:
    """One step of Trainer ``tr`` on inp's x1, x2 (and spk) with inp's
    noise, this rank's rows; its terms averaged over the data axis, every
    gradient whole, the running statistics."""
    from dvc_tpu_torch.parallel.mesh import data_rows
    rows = data_rows(inp["x1"].shape[0], tr.mesh)
    eps = tuple(_t(e[rows]) for e in inp["eps"])
    args = [_t(inp["x1"][rows]), _t(inp["x2"][rows])]
    if "spk" in inp:
        terms, m = tr.train_step(*args, _t(inp["spk"][rows]).long(), eps=eps)
        metrics = _mean_terms([m["adv_ce"], m["adv_acc"]], tr.mesh)
    else:
        terms, metrics = tr.train_step(*args, eps=eps), None
    return {"terms": _mean_terms(terms, tr.mesh), "metrics": metrics,
            "grads": _full_grads(tr.model, tr.mesh, tr.shardings["params"]),
            "adv_grads": (None if tr.adversary is None else
                          {n: p.grad.clone() for n, p in tr.adversary.named_parameters()}),
            "stats": {n: b.clone() for n, b in tr.model.named_buffers() if "running" in n},
            "moment_bytes": tr.optimizer.moment_bytes()}


def _save_orbax(tr, path: str) -> None:
    """Trainer ``tr``'s state as a sharded orbax checkpoint at epoch 1 under
    ``path``, each rank writing the chunks it holds."""
    import dataclasses
    tr.cfg = tr.cfg.replace(train=dataclasses.replace(tr.cfg.train, checkpoint_format="orbax"))
    tr.checkpoints_path = path
    tr.save(1)


def _trainer(inp, ck=None):
    from dvc_tpu_torch.train.trainer import Trainer
    tr = Trainer(inp["cfg"], checkpoints_path=ck or "", device="cpu")
    if ck:
        assert tr.load_last() == 1
    return tr


def scenario_vae4(inp: dict, rank: int, world: int) -> dict:
    """dp 2 x mp 2: the pair step on injected noise from a dvc_tpu
    checkpoint, and its checkpoints (msgpack, and orbax written by every
    rank); then batch 2 on the same 4 ranks (dp 2, two replicas)."""
    from dvc_tpu_torch.parallel.mesh import data_rows
    tr = _trainer(inp, inp["ck"])
    assert (tr.mesh.dp, tr.mesh.mp) == (2, 2)
    out = {"step": _injected_step(tr, inp),
           "tp_dims": {n: p[1] for n, p in tr.shardings["params"].items()}}
    tr.step = 1
    tr.checkpoints_path = inp["ck2"]
    tr.save(1)
    _save_orbax(tr, inp["ock"])
    small = _trainer({"cfg": inp["cfg_b2"]})
    assert (small.mesh.dp, small.mesh.mp) == (2, 1)
    rows = data_rows(2, small.mesh)
    terms = small.step_on(_t(inp["x1"][:2][rows]), _t(inp["x2"][:2][rows]))
    out["b2"] = {"terms": [t.item() for t in terms],
                 "params": {n: p.detach().clone() for n, p in small.model.named_parameters()}}
    return out


def scenario_dp2(inp: dict, rank: int, world: int) -> dict:
    """dp 2: grouped BatchNorm, the multihost helpers, the adversarial step
    and its checkpoints (msgpack, and orbax written by both ranks), the check that the ranks walk one batch, and the
    GE2E steps."""
    import torch.distributed as dist
    from dvc_tpu_torch.config import MeshConfig
    from dvc_tpu_torch.models.layers import BatchNorm
    from dvc_tpu_torch.parallel.multihost import (PerHostBatcher, global_mesh,
                                                  initialize_distributed, is_primary)
    from dvc_tpu_torch.train.speaker_trainer import SpeakerEncoderTrainer
    out = {}
    # grouped BatchNorm over the data axis, two train calls
    for g, bn_in in inp["bn"].items():
        bn = BatchNorm(bn_in["x"][0].shape[1], groups=g).train()
        with torch.no_grad():
            bn.weight.copy_(_t(bn_in["scale"]))
            bn.bias.copy_(_t(bn_in["bias"]))
        bn.data_group = dist.group.WORLD
        ys, dxs = [], []
        for x, gy in zip(bn_in["x"], bn_in["gy"]):
            xl = _t(_group_rows(x, g, world, rank)).requires_grad_()
            y = bn(xl)
            (y * _t(_group_rows(gy, g, world, rank))).sum().backward()
            ys.append(y.detach())
            dxs.append(xl.grad)
        out[f"bn{g}"] = {"y": ys, "dx": dxs, "mean": bn.running_mean.clone(),
                         "var": bn.running_var.clone()}
    # multihost at world 2
    mesh = global_mesh(MeshConfig(), "cpu")
    batcher = PerHostBatcher(mesh)
    out["multihost"] = {"init": initialize_distributed(device="cpu"), "primary": is_primary(),
                        "local_bs": batcher.local_batch_size(16),
                        "rows": batcher.global_batch(np.arange(64, dtype=np.float32
                                                               ).reshape(16, 4)),
                        "mesh": (mesh.dp, mesh.mp)}
    # the adversarial (confusion) step from a dvc_tpu checkpoint, then a save
    tr = _trainer(inp, inp["ck"])
    tr.adversary.load_state_dict(inp["adv_sd"])
    out["adv"] = _injected_step(tr, inp)
    tr.step = 1
    tr.save(1)
    _save_orbax(tr, inp["ock"])
    # a batch the ranks disagree on (an unseeded dataset) is refused on each
    out["same_batch"] = []
    for a in (np.arange(8.0), np.arange(8.0) + rank):
        try:
            tr._check_same_batch(a, a[::-1])
            out["same_batch"].append(True)
        except RuntimeError:
            out["same_batch"].append(False)
    # GE2E: 3 steps from dvc_tpu's weights
    st = SpeakerEncoderTrainer(inp["ge2e_cfg"], device="cpu")
    assert st.mesh is not None and st.mesh.dp == world
    st.model.load_state_dict(inp["ge2e_sd"])
    out["ge2e"] = [st.step_fn(_t(b), with_sim=False).item() for b in inp["ge2e_batches"]]
    return out


def frame_sharded_encoder(x: torch.Tensor, model, mesh) -> torch.Tensor:
    """This rank's (B, T_local, 2 * dim_neck) biLSTM output of the encoder
    on its frames x (B, n_mels, T_local): the conv stack and every LSTM
    direction frame-sharded, as models/long_context.py runs them, without
    the gather."""
    from dvc_tpu_torch.parallel.sequence import (frame_sharded_encode_conv_stack,
                                                 sequence_sharded_lstm)
    h = frame_sharded_encode_conv_stack(x, model, mesh).transpose(1, 2)
    lstm = model.enc_lstm
    for layer in range(lstm.num_layers):
        h = torch.cat([sequence_sharded_lstm(h, *(getattr(lstm, f"{k}_l{layer}{sfx}") for k in
                                                  ("weight_ih", "weight_hh", "bias_ih", "bias_hh")),
                                             mesh, reverse=rev)[0]
                       for sfx, rev in (("", False), ("_reverse", True))], -1)
    return h


def _sequence_grads(inp: dict, rank: int, world: int, mesh) -> dict:
    """Each dtype's gradients on this rank: the ring LSTM both ways (its
    outputs' loss and the replicated final carry's, the carry's part taken
    1 / world on every rank), the conv stack and the whole frame-sharded
    encoder, each of a sum(y * g) loss over this rank's frames."""
    from dvc_tpu_torch.models.disentangled_vae import DisentangledVAE
    from dvc_tpu_torch.parallel.sequence import (frame_sharded_encode_conv_stack,
                                                 sequence_sharded_lstm)
    out = {}
    for name, g in inp["grad"].items():
        res = out[name] = {}
        lstm = g["lstm"]
        t = lstm["x"].shape[1] // world
        cols = slice(rank * t, (rank + 1) * t)
        for rev in (False, True):
            x = _t(lstm["x"][:, cols]).requires_grad_()
            ws = [_t(w).requires_grad_() for w in lstm["w"]]
            y, (h, c) = sequence_sharded_lstm(x, *ws, mesh, reverse=rev)
            ((y * _t(lstm["gy"][:, cols])).sum()
             + ((h * _t(lstm["gh"])).sum() + (c * _t(lstm["gc"])).sum()) / world).backward()
            res[f"lstm_{rev}"] = {"y": y.detach(), "dx": x.grad, "dw": [w.grad for w in ws]}
        model = DisentangledVAE(inp["vae_cfg"])
        model.load_state_dict(inp["vae_sd"])
        model.to(torch.float64 if name == "float64" else torch.float32).eval()
        t = g["mel"].shape[-1] // world
        cols = slice(rank * t, (rank + 1) * t)
        for key, fn, axis in (("stack", frame_sharded_encode_conv_stack, 2),
                              ("enc", frame_sharded_encoder, 1)):
            model.zero_grad()
            x = _t(g["mel"][..., cols]).requires_grad_()
            y = fn(x, model, mesh)
            gy = _t(g[f"g_{key}"]).narrow(axis, rank * t, t)
            (y * gy).sum().backward()
            res[key] = {"dx": x.grad, "dw": {n: p.grad.clone() for n, p in
                                             model.named_parameters() if p.grad is not None}}
    return out


def _inference_callers(inp: dict, mesh) -> dict:
    """whole_utterance_encode(mesh) and convert_mel_long_context(mesh) on
    the tiny VAE, and the encode's frame-sharded forward run again with
    autograd on (the ring's autograd Function), for the tests to hold
    bit-equal."""
    from dvc_tpu_torch.models.disentangled_vae import DisentangledVAE
    from dvc_tpu_torch.models.long_context import (_frame_sharded_encode,
                                                   convert_mel_long_context,
                                                   whole_utterance_encode)
    from dvc_tpu_torch.parallel.collectives import gather_blocks
    from dvc_tpu_torch.parallel.mesh import data_rows
    model = DisentangledVAE(inp["vae_cfg"])
    model.load_state_dict(inp["vae_sd"])
    model.eval()
    whole = whole_utterance_encode(inp["vae_cfg"], model, inp["mel"], mesh)
    x = _t(inp["mel"])
    with torch.inference_mode():
        h_inf = _frame_sharded_encode(model, x, mesh)
    h_grad = frame_sharded_encoder(x[..., data_rows(x.shape[-1], mesh)], model, mesh)
    return {"whole": [a.clone() for a in whole],
            "graphs": [a.grad_fn is not None or a.requires_grad for a in (*whole, h_inf)],
            "autograd_path": h_grad.grad_fn is not None,
            "h_inf": h_inf.clone(), "h_grad": gather_blocks(h_grad.detach(), 1, mesh.data_group),
            "convert": convert_mel_long_context(model, inp["mel"][0], inp["mel"][1],
                                                inp["vae_cfg"].frames, mesh)}


def scenario_seq4(inp: dict, rank: int, world: int) -> dict:
    """Frame-sharded halo convs (and their gradients), the carry-relay LSTM
    both ways, whole_utterance_encode over 4 ranks, and the gradients of
    _sequence_grads."""
    from dvc_tpu_torch.config import MeshConfig
    from dvc_tpu_torch.parallel.mesh import make_mesh
    from dvc_tpu_torch.parallel.sequence import sequence_sharded_conv1d, sequence_sharded_lstm
    mesh = make_mesh(MeshConfig(), "cpu")
    out = {}
    for k, c in inp["conv"].items():
        t = c["x"].shape[-1] // world
        cols = slice(rank * t, (rank + 1) * t)
        x = _t(c["x"][..., cols]).requires_grad_()
        w, b = _t(c["w"]).requires_grad_(), _t(c["b"]).requires_grad_()
        y = sequence_sharded_conv1d(x, w, b, mesh)
        (y * _t(c["gy"][..., cols])).sum().backward()
        out[f"conv{k}"] = {"y": y.detach(), "dx": x.grad, "dw": w.grad, "db": b.grad}
    lx = inp["lstm"]["x"]
    t = lx.shape[1] // world
    for rev in (False, True):
        ys, (h, c) = sequence_sharded_lstm(_t(lx[:, rank * t:(rank + 1) * t]),
                                           *map(_t, inp["lstm"]["w"]), mesh, reverse=rev)
        out[f"lstm_{rev}"] = {"y": ys, "h": h, "c": c}
    out.update(_inference_callers(inp, mesh))
    out["grad"] = _sequence_grads(inp, rank, world, mesh)
    return out


def scenario_seq2(inp: dict, rank: int, world: int) -> dict:
    """The gradients of _sequence_grads, and the inference callers, over 2
    ranks."""
    from dvc_tpu_torch.config import MeshConfig
    from dvc_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(MeshConfig(), "cpu")
    return {**_inference_callers(inp, mesh), "grad": _sequence_grads(inp, rank, world, mesh)}


SCENARIOS = {"vae4": scenario_vae4, "dp2": scenario_dp2, "seq4": scenario_seq4,
             "seq2": scenario_seq2}


def main(argv: list[str]) -> int:
    import torch.distributed as dist
    from dvc_tpu_torch.parallel.multihost import initialize_distributed
    scenario, rank, world, workdir = argv[1], int(argv[2]), int(argv[3]), Path(argv[4])
    torch.set_num_threads(1)
    initialize_distributed(f"file://{workdir / 'store'}", world, rank, device="cpu",
                           timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    inputs = torch.load(workdir / "inputs.pt", weights_only=False)
    out = SCENARIOS[scenario](inputs, rank, world)
    torch.save(out, workdir / f"rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
