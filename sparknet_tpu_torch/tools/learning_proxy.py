"""The cifar10_full learning proxy: accuracy against the communication
period on synthetic data that generalizes.

The port's counterpart of the root ``tools/learning_proxy.py``.  It runs
Caffe's published cifar10_full schedule (reference:
caffe/examples/cifar10/cifar10_full_solver.prototxt and its _lr1/_lr2
continuations: lr 0.001, x0.1 at 60,000 and again at 65,000 iterations,
stop at 70,000; batch 100, momentum 0.9, weight_decay 0.004), divided by
``--scale``, on ``data/synthgen.py``'s textures, three ways:

- ``1x``: one worker, the published config as it is (``local_update``
  of ``solvers/step.py``);
- ``8way``: SparkNet's τ-step local SGD over ``--workers`` contiguous
  partitions of the train set, each worker's momentum kept across
  rounds, the weights averaged at each τ boundary
  (ImageNetApp.scala:100-182);
- ``hier``: 2 hosts x ``workers // 2`` chips on the same partitions, the
  chips' mean gradient each step within a host and the hosts' weights
  averaged at each τ boundary.

The train and test sets live on the device as uint8 (the Datum's bytes),
and each minibatch is gathered there by index and put through Caffe's
DataTransformer on the device (``ops/augment.py``: cast, then the mean
image subtracted).  The minibatch indices come from the JAX tool's numpy
seeds (5, 6, 7), so both tools see the same index stream.  8-way and
hier are the port's ``DistributedTrainer`` rounds (``local_sgd`` and
``hierarchical``): their workers run one after another on one card.

It writes the JAX tool's RESULTS schema (``config``, ``device``,
``curve_1x``, ``curve_8way``, ``curve_hier``, ``final``; each row iter,
lr, train_loss, train_acc, test_acc, wall_s), and ``final`` adds each
run's images a second on its device (``img_s_*``: every worker's
images over the seconds of its training steps, evaluations left out).
Every eval chunk saves ``<out>.resume_<tag>.npz`` and every finished
curve ``<out>.partial``, so a rerun resumes bit for bit (``--fresh``
ignores them; a CUDA error exits 17 for a rerun to continue);
``--runs``/``--merge`` run some curves and take the rest from a file.

Run:  python -m sparknet_tpu_torch.tools.learning_proxy [--scale 10]
          [--out RESULTS_learning_proxy_torch.json] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

DEFAULT_OUT = "RESULTS_learning_proxy_torch.json"
HOSTS = 2           # hier's hosts
BATCH = 100         # cifar10_full's published batch


def schedule(scale: int, base_lr: float = 0.001) -> tuple[str, int, tuple]:
    """(solver text, max_iter, stepvalues) of the published schedule
    divided by ``scale``."""
    max_iter = 70000 // scale
    steps = (60000 // scale, 65000 // scale)
    text = (f"base_lr: {base_lr}\nmomentum: 0.9\nweight_decay: 0.004\n"
            'lr_policy: "multistep"\ngamma: 0.1\n'
            f"stepvalue: {steps[0]}\nstepvalue: {steps[1]}\n"
            f"max_iter: {max_iter}\n")
    return text, max_iter, steps


def device_of(args):
    """The run's device: ``--device``, else ``--platform`` (the JAX
    tool's flag; ``cpu`` picks the CPU), else the card."""
    from ..utils.device import resolve_device
    name = args.device or ("cpu" if args.platform == "cpu" else "cuda")
    return resolve_device(name)


def device_name(dev) -> str:
    import torch
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    return f"{dev.type}/{kind}"


class Proxy:
    """The data on the device, the nets and the initial params: what
    every run of the proxy and the τ sweep shares."""

    def __init__(self, sp_text: str, n_train: int, n_test: int, dev,
                 batch: int = BATCH, params0=None, **data_kw):
        import torch

        from ..data.synthgen import synth_splits
        from ..graph.net import Net
        from ..models import cifar10_full
        from ..ops.augment import AugmentSpec
        from ..proto import NetState, Phase, load_solver_prototxt_with_net
        from ..solvers.step import make_step_fns
        from ..solvers.update_rules import make_update_rule

        t0 = time.time()
        train_x, train_y, test_x, test_y = synth_splits(n_train, n_test,
                                                        **data_kw)
        # uint8, the Datum's format; the mean image is subtracted on the
        # device, as DataTransformer does after reading the bytes
        train_q = np.clip(np.round(train_x), 0, 255).astype(np.uint8)
        test_q = np.clip(np.round(test_x), 0, 255).astype(np.uint8)
        mean = train_q.astype(np.float32).mean(axis=0, keepdims=True)
        self.gen_s = time.time() - t0
        self.dev, self.batch = dev, batch
        self.n_train, self.n_test = n_train, n_test
        self.tx = torch.from_numpy(train_q).to(dev)
        self.ty = torch.from_numpy(train_y.astype(np.float32)).to(dev)
        self.vx = torch.from_numpy(test_q).to(dev)
        self.vy = torch.from_numpy(test_y.astype(np.float32)).to(dev)
        self.spec = AugmentSpec(mean=torch.from_numpy(mean[0]).to(dev))
        net = cifar10_full(batch, batch)
        self.sp = load_solver_prototxt_with_net(sp_text, net)
        self.train_net = Net(net, NetState(Phase.TRAIN))
        self.test_net = Net(net, NetState(Phase.TEST))
        self.rule = make_update_rule(self.sp)
        if params0 is None:
            params0 = self.train_net.init(torch.Generator().manual_seed(0),
                                          device=dev)
        self.params0 = {k: [torch.as_tensor(np.array(b, np.float32))
                            .to(dev) if not isinstance(b, torch.Tensor)
                            else b.detach().to(dev, torch.float32)
                            for b in v] for k, v in params0.items()}
        _, self.local_update, _ = make_step_fns(
            self.sp, self.train_net, self.rule,
            self.train_net.lr_mult_tree(self.params0),
            self.train_net.decay_mult_tree(self.params0))

    def prep(self, img_u8):
        """uint8 pixels -> mean-subtracted f32 on the device
        (``ops/augment.py``, crop 0, no mirror: nothing drawn)."""
        from ..ops.augment import apply
        n = img_u8.shape[0]
        zeros = np.zeros(n, np.int32)
        return apply(img_u8, zeros, zeros, zeros, self.spec)

    def preprocess(self, micro, _gen):
        """``TrainerConfig.device_preprocess``: ``prep`` on a worker's
        [iter_size, batch, ...] micro-batch."""
        data = micro["data"]
        out = self.prep(data.reshape((-1,) + tuple(data.shape[2:])))
        return {**micro, "data": out.reshape(data.shape)}

    def chunk_1x(self, params, state, it: int, idxs):
        """1x's steps ``it``, ``it + 1``, ... on the minibatches of
        ``idxs`` [n, batch] (train-set indices); returns (params, state,
        the steps' mean loss as a 0-d tensor)."""
        import torch
        idxs = torch.as_tensor(idxs).to(self.dev)
        losses = []
        for j in range(idxs.shape[0]):
            b = {"data": self.prep(self.tx[idxs[j]])[None],
                 "label": self.ty[idxs[j]][None]}
            params, state, loss = self.local_update(params, state, it + j,
                                                    b, None)
            losses.append(loss)
        return params, state, torch.stack(losses).mean()

    def clone_params(self):
        return {k: [b.clone() for b in v] for k, v in self.params0.items()}

    def accuracy(self, params, x, y) -> float:
        """Mean of the test net's accuracy over ``x``'s whole batches."""
        import torch
        nb = x.shape[0] // self.batch
        total = torch.zeros((), device=self.dev)
        with torch.no_grad():
            for i in range(nb):
                sl = slice(i * self.batch, (i + 1) * self.batch)
                out = self.test_net.forward(
                    params, {"data": self.prep(x[sl]), "label": y[sl]},
                    train=False, device=self.dev)
                total = total + out.blobs["accuracy"]
        return float(total / nb)

    def row(self, it: int, loss, params) -> dict:
        from ..solvers.lr_policies import learning_rate
        return {"iter": it,
                "lr": float(learning_rate(self.sp, it - 1)),
                "train_loss": float(loss),
                "train_acc": self.accuracy(params, self.tx[:self.n_test],
                                           self.ty[:self.n_test]),
                "test_acc": self.accuracy(params, self.vx, self.vy)}

    def trainer(self, strategy: str, workers: int, tau: int,
                codec: str = "none"):
        """A ``DistributedTrainer`` of ``strategy`` from ``params0``,
        with ``prep`` as its device preprocess."""
        from ..parallel import (DistributedTrainer, TrainerConfig,
                                make_mesh, make_pod_mesh)
        layout = (make_pod_mesh(HOSTS, workers // HOSTS)
                  if strategy == "hierarchical" else make_mesh(workers))
        tr = DistributedTrainer(self.sp, layout, TrainerConfig(
            strategy=strategy, tau=tau, device_preprocess=self.preprocess,
            comm_codec=codec), device=self.dev)
        tr.params = self.clone_params()
        tr.state = tr.init_state()
        return tr

    def round_batches(self, idxs) -> dict:
        """A round's minibatches from partition-local indices [tau,
        workers, batch]: worker w reads partition w."""
        import torch
        tau, workers, batch = idxs.shape
        part = self.n_train // workers
        flat = torch.from_numpy(
            (idxs + np.arange(workers)[:, None] * part).reshape(tau, -1)
        ).to(self.dev)
        return {"data": self.tx[flat], "label": self.ty[flat]}


def device_lost(err: RuntimeError, dev) -> bool:
    """True for a CUDA error on the card (the run can resume from its
    checkpoint), False for any other fault."""
    return dev.type == "cuda" and "CUDA" in str(err)


def sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def main(argv=None, *, params0=None) -> int:
    """``params0``: the initial params ({layer: [arrays]}) in place of
    the port's own init (tests start both tools from one init)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=10,
                    help="schedule divisor vs the published 70k config")
    ap.add_argument("--tau", type=int, default=10)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--n-train", type=int, default=10000)
    ap.add_argument("--n-test", type=int, default=2000)
    ap.add_argument("--eval-every", type=int, default=250)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--platform", default=None,
                    help="the JAX tool's backend flag: cpu runs on the CPU")
    ap.add_argument("--runs", default="1x,8way,hier",
                    help="which curves to execute this invocation")
    ap.add_argument("--merge", default=None,
                    help="JSON (a previous out or .partial) supplying "
                         "curves not in --runs")
    ap.add_argument("--fresh", action="store_true",
                    help="ignore <out>.resume_* checkpoints")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)

    import torch

    from ..utils.device import full_f32

    selected = set(args.runs.split(","))
    merged = {}
    if args.merge:
        with open(args.merge) as f:
            merged = json.load(f)
    dev = device_of(args)
    S = args.scale
    sp_text, max_iter, steps = schedule(S)
    px = Proxy(sp_text, args.n_train, args.n_test, dev, params0=params0)
    print(f"# {device_name(dev)}; generated {args.n_train}+{args.n_test} "
          f"images in {px.gen_s:.1f}s", flush=True)
    W, tau, batch = args.workers, args.tau, BATCH
    part = args.n_train // W

    def resume_path(tag):
        return f"{args.out}.resume_{tag}.npz"

    def save_resume(tag, it, tree, curve, wall, train_s):
        np.savez(resume_path(tag), __iter__=it, __curve__=json.dumps(curve),
                 __wall__=float(wall), __train__=float(train_s),
                 **{f"l{i}": t.detach().cpu().numpy()
                    for i, t in enumerate(_leaves(tree))})

    def load_resume(tag, tree):
        """Restores ``tree``'s tensors in place; (iter, curve, wall,
        train seconds) or None."""
        path = resume_path(tag)
        if args.fresh or not os.path.exists(path):
            return None
        with np.load(path) as z:
            for i, t in enumerate(_leaves(tree)):
                t.copy_(torch.from_numpy(z[f"l{i}"]))
            return (int(z["__iter__"]), json.loads(str(z["__curve__"])),
                    float(z["__wall__"]), float(z["__train__"]))

    def transient_exit(tag, it, err):
        print(f"{tag}: device lost at iter {it} ({type(err).__name__}: "
              f"{err}); the resume checkpoint is on disk, rerun to "
              f"continue", flush=True)
        raise SystemExit(17)

    def report(tag, it, row):
        print(f"{tag:4s} iter {it:5d} lr {row['lr']:.0e} "
              f"loss {row['train_loss']:.3f} "
              f"train_acc {row['train_acc']:.3f} "
              f"test_acc {row['test_acc']:.3f}", flush=True)

    def run_1x():
        rng_idx = np.random.default_rng(5)
        params = px.clone_params()
        state = px.rule.init(params)
        curve, it, wall0, train_s = [], 0, 0.0, 0.0
        r = load_resume("1x", (params, state))
        if r:
            it, curve, wall0, train_s = r
            for _ in range(it // args.eval_every):  # fast-forward
                rng_idx.integers(0, args.n_train,
                                 size=(args.eval_every, batch))
            print(f"1x   resuming at iter {it} ({wall0:.1f}s "
                  f"accumulated)", flush=True)
        t_run = time.time()
        while it < max_iter:
            n = min(args.eval_every, max_iter - it)
            idxs = rng_idx.integers(0, args.n_train, size=(n, batch))
            try:
                t0 = time.perf_counter()
                params, state, loss = px.chunk_1x(params, state, it, idxs)
                sync(dev)
                train_s += time.perf_counter() - t0
                it += n
                row = px.row(it, loss, params)
            except RuntimeError as e:
                if not device_lost(e, dev):
                    raise
                transient_exit("1x", it, e)
            row["wall_s"] = round(wall0 + time.time() - t_run, 1)
            curve.append(row)
            save_resume("1x", it, (params, state), curve, row["wall_s"],
                        train_s)
            report("1x", it, row)
        return curve, wall0 + time.time() - t_run, it * batch / train_s

    def run_rounds(tag, strategy, idx_seed):
        tr = px.trainer(strategy, W, tau)
        rng_idx = np.random.default_rng(idx_seed)
        curve, it, wall0, train_s = [], 0, 0.0, 0.0
        rounds_per_eval = max(args.eval_every // tau, 1)
        chunk_iters = rounds_per_eval * tau
        r = load_resume(tag, (tr.params, tr.state))
        if r:
            it, curve, wall0, train_s = r
            tr.iter, tr.round = it, it // tau
            for _ in range(it // chunk_iters):     # fast-forward
                rng_idx.integers(0, part,
                                 size=(rounds_per_eval, tau, W, batch))
            print(f"{tag:4s} resuming at iter {it} ({wall0:.1f}s "
                  f"accumulated)", flush=True)
        t_run = time.time()
        while it < max_iter:
            n_rounds = min(rounds_per_eval, (max_iter - it) // tau)
            if n_rounds == 0:
                break
            # [rounds, tau, W, batch]: hier's [H, C] is the worker axis
            idxs = rng_idx.integers(0, part,
                                    size=(n_rounds, tau, W, batch))
            try:
                t0 = time.perf_counter()
                losses = [tr.train_round(px.round_batches(i)) for i in idxs]
                sync(dev)
                train_s += time.perf_counter() - t0
                it += n_rounds * tau
                row = px.row(it, float(np.mean(losses)), tr.params)
            except RuntimeError as e:
                if not device_lost(e, dev):
                    raise
                transient_exit(tag, it, e)
            row["wall_s"] = round(wall0 + time.time() - t_run, 1)
            curve.append(row)
            save_resume(tag, it, (tr.params, tr.state), curve,
                        row["wall_s"], train_s)
            report(tag, it, row)
        return (curve, wall0 + time.time() - t_run,
                it * batch * W / max(train_s, 1e-9))

    partial: dict = {}

    def execute(tag, key, wall_key, run_fn):
        """Run the curve if selected, else take it from --merge."""
        if tag in selected:
            curve, wall, img_s = run_fn()
            partial[key] = curve
            partial[wall_key] = round(wall, 1)
            partial[f"img_s_{tag}"] = round(img_s, 1)
            with open(args.out + ".partial", "w") as f:
                json.dump({"partial": True, **partial}, f)
            return curve, partial[wall_key], partial[f"img_s_{tag}"]
        if key not in merged:
            raise SystemExit(
                f"run {tag!r} not selected and {key!r} absent from "
                f"--merge; pass --runs {tag} or a merge file that has it")
        return (merged[key], merged.get(wall_key),
                merged.get("final", merged).get(f"img_s_{tag}"))

    with full_f32():
        curve_1x, t_1x, i_1x = execute("1x", "curve_1x", "wall_s_1x",
                                       run_1x)
        curve_8, t_8, i_8 = execute(
            "8way", "curve_8way", "wall_s_8way",
            lambda: run_rounds("8way", "local_sgd", 6))
        curve_h, t_h, i_h = execute(
            "hier", "curve_hier", "wall_s_hier",
            lambda: run_rounds("hier", "hierarchical", 7))

    final_1x, final_8, final_h = curve_1x[-1], curve_8[-1], curve_h[-1]
    at_drop = [r for r in curve_1x if r["iter"] <= steps[0]]
    pre_drop = at_drop[-1] if at_drop else curve_1x[0]
    result = {
        "config": {
            "published": "cifar10_full_solver.prototxt (+_lr1/_lr2): "
                         "lr 0.001, x0.1 @ 60000 and 65000, stop 70000",
            "scale": S, "max_iter": max_iter, "stepvalues": list(steps),
            "batch": batch, "n_train": args.n_train, "n_test": args.n_test,
            "workers": W, "tau": tau,
            "hier_topology": f"{HOSTS}x{W // HOSTS}",
            "dataset": "synthgen class-conditional textures + distractors "
                       "+ noise (Bayes error > 0)",
        },
        "device": device_name(dev),
        "curve_1x": curve_1x,
        "curve_8way": curve_8,
        "curve_hier": curve_h,
        "final": {
            "acc_1x": final_1x["test_acc"],
            "acc_8way": final_8["test_acc"],
            "acc_hier": final_h["test_acc"],
            "delta": round(final_8["test_acc"] - final_1x["test_acc"], 4),
            "delta_hier": round(
                final_h["test_acc"] - final_1x["test_acc"], 4),
            "train_test_gap_1x": round(
                final_1x["train_acc"] - final_1x["test_acc"], 4),
            "train_test_gap_8way": round(
                final_8["train_acc"] - final_8["test_acc"], 4),
            "train_test_gap_hier": round(
                final_h["train_acc"] - final_h["test_acc"], 4),
            "lr_drop_response_1x": round(
                final_1x["test_acc"] - pre_drop["test_acc"], 4),
            "wall_s_1x": t_1x, "wall_s_8way": t_8, "wall_s_hier": t_h,
            "img_s_1x": i_1x, "img_s_8way": i_8, "img_s_hier": i_h,
        },
    }
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({"final": result["final"]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
