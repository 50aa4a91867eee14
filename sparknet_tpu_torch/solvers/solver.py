"""The host-level Solver: ``Solver::Step``/``Solve`` on tensors.

The port's counterpart of ``sparknet_tpu/solvers/solver.py`` (:42-643),
the Caffe solver surface that SparkNet's ``CaffeNet`` handle wraps and
that ``caffe train``, pycaffe's ``get_solver`` and serving's
``LoadedModel(weights=)`` go through.  It mirrors the reference's
training loop (caffe/src/caffe/solver.cpp:193-283 ``Step``: iter_size
forward/backward accumulation -> smoothed loss -> ApplyUpdate -> optional
snapshot) and its test pass (``Solver::Test``, solver.cpp:413-445: each
test net run N times, every output element summed).

PyTorch runs eagerly: one step is ``solvers/step.py``'s ``local_update``
(autograd, ``iter_size`` accumulation, ``preprocess_grads``, the rule in
place) on the Solver's device.  The loss stays a device scalar until a
display boundary or the end of ``step(n)``, so the host loop never waits
on the card per iteration.  Params are ``{layer: [tensor, ...]}`` f32
masters on ``device``; init and Dropout draw from CPU
``torch.Generator``s (the same draws on the card and on the CPU).  f32
nets run their steps and test passes in full f32 (TF32 off,
``utils.device.full_f32``).

Weights and state on disk: ``snapshot``/``restore`` write and read the
JAX package's npz layout (``utils/checkpoint.py``);
``snapshot_caffe``/``restore_caffe`` the ``.caffemodel`` + ``.solverstate``
pair Caffe writes; ``load_weights`` reads npz or ``.caffemodel`` (V1 zoo
files included).  Not ported yet, and refused by name: ``set_augment``
(ROADMAP A14), ``debug_info`` (A13), ``snapshot_format: HDF5`` and HDF5
weight files (A6), shared params (A3, in ``graph/net.py``).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
from typing import Any, Callable, Iterator, Mapping

import numpy as np
import torch

from ..graph.net import Net, Params
from ..proto.caffe_pb import NetState, Phase, SolverParameter
from ..utils.device import full_f32, resolve_device
from ..utils.glog import log_line
from .lr_policies import learning_rate
from .step import make_step_fns
from .update_rules import make_update_rule

_HDF5_MAGIC = b"\x89HDF"


def _refuse_hdf5(what: str) -> None:
    raise NotImplementedError(
        f"{what}: HDF5 weights and snapshots are not ported yet (ROADMAP "
        f"A6); use the BINARYPROTO .caffemodel/.solverstate pair")


def load_weights_into(net: Net, params: Params, path: str) -> Params:
    """Weights-only load into an existing (net, params) pair, the
    Net::CopyTrainedLayersFrom path without a full Solver (serving's
    ``LoadedModel(weights=)``).  Layers of the file that ``net`` lacks are
    ignored (train weights into a deploy net); a layer it has must match
    in blob count and shape.  ``params`` is updated and returned."""
    loader = Solver.__new__(Solver)
    loader.params = params
    loader.train_net = net
    loader.load_weights(path)
    return loader.params


class Solver:
    """Owns the params and the update rule's state on ``device``, the
    iteration count, the Dropout generator and the test nets.

    ``Solver(sp, seed=None, device="cuda", compute_dtype=None)``: the net
    is ``sp.net_param`` or ``sp.train_net_param`` in the TRAIN phase; the
    test nets are one per ``sp.test_net_param`` entry, else the shared
    net in the TEST phase (Solver::InitTestNets precedence,
    solver.cpp:104-172), and every one is evaluated.  A test net's layers
    that the train net lacks keep their filler init.  ``seed`` defaults
    to ``sp.random_seed`` when set, else 0.
    """

    _HISTORY_SLOTS = {
        "SGD": ("history",), "NESTEROV": ("history",),
        "ADAGRAD": ("history",), "RMSPROP": ("history",),
        "ADADELTA": ("sq_grad", "sq_update"), "ADAM": ("m", "v"),
    }

    def __init__(self, sp: SolverParameter, *, seed: int | None = None,
                 device: str | torch.device = "cuda",
                 compute_dtype: torch.dtype | None = None):
        if sp.debug_info:
            raise NotImplementedError(
                "debug_info (per-blob forward and update dumps) is not "
                "ported yet (ROADMAP A13)")
        if sp.snapshot_format == "HDF5":
            _refuse_hdf5("snapshot_format: HDF5")
        net_param = sp.net_param or sp.train_net_param
        if net_param is None:
            raise ValueError("SolverParameter carries no net definition")
        if seed is None:
            seed = sp.random_seed if sp.random_seed >= 0 else 0
        self.sp = sp
        self.device = resolve_device(device)
        self.train_net = Net(net_param, NetState(Phase.TRAIN),
                             compute_dtype=compute_dtype)
        self._dedicated_test_net = bool(sp.test_net_param)
        self.test_nets = [Net(tp, NetState(Phase.TEST),
                              compute_dtype=compute_dtype)
                          for tp in (list(sp.test_net_param) or [net_param])]
        self.test_net = self.test_nets[0]
        self.rule = make_update_rule(sp)
        self.params: Params = self.train_net.init(
            torch.Generator().manual_seed(seed), device=self.device)
        # test-only layers keep their filler init (Net::ShareTrainedLayersWith,
        # net.cpp:737): drawn from a generator of their own per test net
        self._test_extras: list[Params] = []
        for i, tn in enumerate(self.test_nets):
            extra: Params = {}
            if self._dedicated_test_net and any(
                    k not in self.params for k in tn.param_shapes()):
                full = tn.init(torch.Generator().manual_seed(seed + i + 1),
                               device=self.device)
                extra = {k: v for k, v in full.items()
                         if k not in self.params}
            self._test_extras.append(extra)
        self.state = self.rule.init(self.params)
        self.iter = 0
        # the CPU generator train-mode Dropout draws from (the trainer's
        # worker 0 draws from the same seed)
        self.generator = torch.Generator().manual_seed(seed * 7919 + 1)
        # the one test passes' random DummyData tops draw from (Dropout
        # draws nothing at test)
        self.test_generator = torch.Generator().manual_seed(seed * 7919 + 2)
        self._lr_mults = self.train_net.lr_mult_tree(self.params)
        self._decay_mults = self.train_net.decay_mult_tree(self.params)
        _, self._local_update, _ = make_step_fns(
            sp, self.train_net, self.rule, self._lr_mults,
            self._decay_mults)
        self._precision = (full_f32 if compute_dtype is None
                           else contextlib.nullcontext)
        self._smoothed: collections.deque = collections.deque(
            maxlen=max(sp.average_loss, 1))
        self._signal_guard = None       # installed by solve(), polled in step()
        self._stop_requested = False
        self._train_iter: Iterator[Mapping[str, Any]] | None = None
        self._test_iter_factories: list[
            Callable[[], Iterator[Mapping[str, Any]]] | None] = \
            [None] * len(self.test_nets)

    # -- data (CaffeNet.setTrainData/setTestData; reference:
    #    src/main/scala/libs/Net.scala:79-92) --------------------------------
    def set_train_data(self, it: Iterator[Mapping[str, Any]]) -> None:
        """The train feed: an iterator of {input blob: array or tensor}
        minibatches (tensors already on the device are used as they are)."""
        self._train_iter = it

    def set_test_data(self, factory: Callable[[], Iterator[Mapping[str, Any]]],
                      net_id: int = 0) -> None:
        """A callable that starts test net ``net_id``'s feed afresh for each
        test pass."""
        self._test_iter_factories[net_id] = factory

    def set_augment(self, spec, device: bool | None = None,
                    blob: str = "data") -> None:
        raise NotImplementedError(
            "set_augment (crop/mirror/mean folded into the train step, "
            "ops/augment.py) is not ported yet (ROADMAP A14)")

    def _ensure_test_factory(self, net_id: int = 0) -> None:
        if self._test_iter_factories[net_id] is None:
            if self.test_nets[net_id].input_blobs:
                raise RuntimeError(
                    "no test data set; call set_test_data first")
            self._test_iter_factories[net_id] = lambda: itertools.repeat({})

    def _to_device(self, v) -> torch.Tensor:
        return torch.as_tensor(v).to(self.device)

    def _next_batches(self) -> dict[str, torch.Tensor]:
        """``iter_size`` minibatches stacked on a leading axis."""
        batches = [dict(next(self._train_iter))
                   for _ in range(self.sp.iter_size)]
        return {k: torch.stack([self._to_device(b[k]) for b in batches])
                for k in batches[0]}

    # -- Solver::Step (reference: solver.cpp:193-283) -----------------------
    def step(self, n: int) -> float:
        """Run ``n`` iterations pulling minibatches from the train feed;
        returns the smoothed loss (solver.cpp:226-235 average_loss)."""
        if self._train_iter is None:
            if self.train_net.input_blobs:
                raise RuntimeError(
                    "no train data set; call set_train_data first")
            self._train_iter = itertools.repeat({})
        loss = torch.zeros(())
        for _ in range(n):
            batches = self._next_batches()
            with self._precision():
                self.params, self.state, loss = self._local_update(
                    self.params, self.state, self.iter, batches,
                    self.generator)
            # the loss stays on the device: smoothed_loss() fetches the
            # window, so the host waits only at display boundaries and at
            # the end of the call
            self._smoothed.append(loss)
            self.iter += 1
            if self.sp.display and self.iter % self.sp.display == 0:
                log_line(f"Iteration {self.iter}, "
                         f"loss = {self.smoothed_loss():.6f}")
                log_line(f"Iteration {self.iter}, "
                         f"lr = {learning_rate(self.sp, self.iter):g}")
            # snapshot on schedule (reference: solver.cpp:270-277)
            if (self.sp.snapshot and self.sp.snapshot_prefix
                    and self.iter % self.sp.snapshot == 0):
                self.snapshot_caffe()
            # signals are polled per iteration (solver.cpp:270-281)
            if self._signal_guard is not None:
                from ..utils.signals import SolverAction
                action = self._signal_guard.check()
                if action == SolverAction.SNAPSHOT and self.sp.snapshot_prefix:
                    print(f"Snapshotting (signal) at iter {self.iter}")
                    self.snapshot_caffe()
                elif action in (SolverAction.STOP,
                                SolverAction.SNAPSHOT_STOP):
                    self._stop_requested = True
                    break
        return self.smoothed_loss() if self._smoothed else float(loss)

    def solve(self, max_iter: int | None = None) -> float:
        """Train to ``max_iter`` on Solver::Solve's schedule (reference:
        solver.cpp:285-330): a test pass at the start (test_initialization,
        or a resume on an interval boundary), one every ``test_interval``
        and a final one; display and snapshots in ``step``; SIGHUP
        snapshots, SIGINT and SIGTERM stop at the next iteration after a
        snapshot.  Returns the final smoothed loss."""
        from ..utils.signals import SignalGuard
        sp = self.sp
        max_iter = max_iter or sp.max_iter or 100
        if sp.test_interval:
            for i, tn in enumerate(self.test_nets):
                if not tn.input_blobs:
                    self._ensure_test_factory(i)
        interval = sp.test_interval \
            if (sp.test_interval and any(self._test_iter_factories)) else 0
        test_iter = sp.test_iter[0] if sp.test_iter else 50
        if interval and self.iter % interval == 0 and (
                self.iter > 0 or sp.test_initialization):
            self._print_test_scores(test_iter)
        loss = 0.0
        self._stop_requested = False
        with SignalGuard() as guard:
            self._signal_guard = guard
            try:
                while self.iter < max_iter:
                    n = (min(interval - self.iter % interval,
                             max_iter - self.iter)
                         if interval else max_iter - self.iter)
                    loss = self.step(n)
                    if self._stop_requested:
                        print(f"Optimization stopped early (signal) at "
                              f"iter {self.iter}")
                        if sp.snapshot_prefix:
                            self.snapshot_caffe()
                        return loss
                    log_line(f"Iteration {self.iter}, loss = {loss:.6f}")
                    if interval:
                        self._print_test_scores(test_iter)
            finally:
                self._signal_guard = None
        print("Optimization Done.")
        return loss

    def _print_test_scores(self, default_iter: int) -> None:
        """Evaluate every test net with a feed (Solver::TestAll,
        solver.cpp:407-411), each with its own test_iter."""
        multi = len(self.test_nets) > 1
        for n in range(len(self.test_nets)):
            if (self._test_iter_factories[n] is None
                    and self.test_nets[n].input_blobs):
                continue
            ti = self._test_iter_for(n) if self.sp.test_iter else default_iter
            log_line(f"Iteration {self.iter}, Testing net (#{n})")
            tag = f" #{n}" if multi else ""
            for k, v in self.test(ti, net_id=n).items():
                arr = np.asarray(v, np.float64) / ti
                if arr.ndim == 0:
                    log_line(
                        f"    Test net{tag} output: {k} = {float(arr):.6f}")
                else:
                    for i, x in enumerate(arr.reshape(-1)):
                        log_line(f"    Test net{tag} output: "
                                 f"{k}[{i}] = {float(x):.6f}")

    def smoothed_loss(self) -> float:
        """Mean of the trailing ``average_loss`` window of losses
        (solver.cpp:226-235): the one place they are fetched from the
        device."""
        if not self._smoothed:
            return 0.0
        vals = torch.stack([v.reshape(()).float() for v in self._smoothed])
        return float(sum(vals.double().cpu().tolist()) / len(self._smoothed))

    # -- test pass (Solver::Test; reference: solver.cpp:413-445) ------------
    def test(self, num_steps: int | None = None,
             net_id: int = 0) -> dict[str, Any]:
        """Run test net ``net_id`` ``num_steps`` times on the current
        params, summing every element of every output blob: scalars come
        back as floats, vector outputs as numpy arrays.  Runs under
        ``torch.no_grad()``, so the forward takes the inference kernels."""
        self._ensure_test_factory(net_id)
        if num_steps is None:
            num_steps = self._test_iter_for(net_id)
        it = self._test_iter_factories[net_id]()
        tn = self.test_nets[net_id]
        extra = self._test_extras[net_id]
        params = {**extra, **self.params} if extra else self.params
        totals: dict[str, torch.Tensor] = {}
        with torch.no_grad(), self._precision():
            for _ in range(num_steps):
                batch = {k: self._to_device(v)
                         for k, v in dict(next(it)).items()}
                out = tn.forward(params, batch, train=False,
                                 generator=self.test_generator,
                                 device=self.device)
                for k, v in out.blobs.items():
                    v = v.float()
                    totals[k] = v if k not in totals else totals[k] + v
        return {k: float(v) if v.dim() == 0 else v.cpu().numpy()
                for k, v in totals.items()}

    def _test_iter_for(self, net_id: int) -> int:
        """Per-net test_iter (one per test net, solver.cpp:36-44); the
        last value repeats."""
        ti = self.sp.test_iter
        if not ti:
            return 1
        return ti[net_id] if net_id < len(ti) else ti[-1]

    # -- npz checkpoints (the JAX package's layout) -------------------------
    def snapshot(self, path: str) -> None:
        """Params, rule state and iteration as a checksummed npz in the
        JAX Solver's layout, plus the Dropout generator's state under
        ``torch_generator`` (which the JAX package ignores)."""
        from ..utils.checkpoint import save_checkpoint
        save_checkpoint(path, {
            "params": self.params, "state": self.state, "iter": self.iter,
            "torch_generator": self.generator.get_state().numpy()})

    def restore(self, path: str) -> None:
        """Read a snapshot written by either package's ``snapshot``."""
        from ..utils.checkpoint import load_checkpoint
        blob = load_checkpoint(path)

        def dev(tree):
            for k in self.params:
                if len(tree[k]) != len(self.params[k]):
                    raise ValueError(f"{path}: layer {k!r} has "
                                     f"{len(tree[k])} blobs, the net "
                                     f"{len(self.params[k])}")
            return {k: [self._blob_tensor(self._shape_adapt(
                b, like.shape, f"{path}: layer {k!r} blob {i}"), like)
                for i, (b, like) in enumerate(zip(tree[k], self.params[k]))]
                for k in self.params}

        params = dev(blob["params"])
        state = {slot: dev(tree) for slot, tree in blob["state"].items()}
        if set(state) != set(self.state):
            raise ValueError(f"snapshot state slots {sorted(state)} != the "
                             f"{self.rule.name} rule's {sorted(self.state)}")
        self.params, self.state = params, state
        self.iter = int(blob["iter"])
        if "torch_generator" in blob:
            self.generator.set_state(torch.from_numpy(
                np.array(blob["torch_generator"], np.uint8)))

    # -- weights (Net::CopyTrainedLayersFrom; reference: net.cpp:805-848) ---
    def load_weights(self, path: str) -> None:
        """Copy the blobs of a weight file into the layers of the same
        name, leaving the rest initialized.  The file type is sniffed: npz
        (``PK``: a checkpoint's ``params``, or a bare weight tree), HDF5
        (refused, ROADMAP A6), else a binary ``.caffemodel`` (V1 zoo files
        included).  Raises on a file that carries no weights and on a
        blob count or shape the net does not accept."""
        with open(path, "rb") as f:
            magic = f.read(4)
        if magic == _HDF5_MAGIC:
            _refuse_hdf5(path)
        if magic[:2] == b"PK":
            from ..utils.checkpoint import load_checkpoint
            blob = load_checkpoint(path)
            saved = blob["params"] if "params" in blob else blob
        else:
            from ..proto.caffemodel import load_caffemodel
            saved = load_caffemodel(path)
        if not saved:
            raise ValueError(f"{path}: the file carries no weight blobs")
        self.copy_trained_layers_from(saved)

    @staticmethod
    def _shape_adapt(src, dst_shape, where: str) -> np.ndarray:
        """Legacy-shape tolerance and no broader: a saved blob is reshaped
        only when its dims equal the net's but for size-1 axes (the legacy
        4-d spellings such as (1, 1, N, K) of an (N, K) InnerProduct
        weight; Blob::ShapeEquals, reference: blob.cpp).  Any other
        mismatch raises, as Caffe's shape CHECKs do: a same-size layout
        difference (a transposed weight) is never reshaped."""
        if isinstance(src, torch.Tensor):
            src = src.detach().cpu().numpy()
        src = np.asarray(src)
        dst_shape = tuple(dst_shape)
        if src.shape == dst_shape:
            return src
        squeeze = lambda s: tuple(d for d in s if d != 1)
        if squeeze(src.shape) != squeeze(dst_shape):
            raise ValueError(
                f"{where}: checkpoint shape {src.shape} incompatible with "
                f"net shape {dst_shape}")
        return src.reshape(dst_shape)

    @staticmethod
    def _blob_tensor(src: np.ndarray, like: torch.Tensor) -> torch.Tensor:
        """A saved blob as a tensor of ``like``'s dtype on its device (a
        copy: a decoded blob is a read-only view of the file's bytes)."""
        return torch.from_numpy(np.array(src, np.float32)).to(
            like.device, like.dtype)

    def copy_trained_layers_from(self, saved: Mapping[str, list]) -> None:
        """Copy blobs by layer name (Net::CopyTrainedLayersFrom; reference:
        net.cpp:805-842): layers the net lacks are ignored, a layer it has
        must match in blob count and in shape (legacy size-1 axes aside).
        Every layer is validated before any is written: a failed load
        leaves the params as they were."""
        names = {n.lp.name for n in self.train_net.nodes}
        staged: dict[str, list[torch.Tensor]] = {}
        for name, blobs in saved.items():
            if name not in names:
                continue
            target = self.params.get(name, [])
            blobs = list(blobs)
            if not target and not blobs:
                continue
            if len(blobs) != len(target):
                raise ValueError(
                    f"layer {name!r}: checkpoint has {len(blobs)} blobs, "
                    f"net expects {len(target)}")
            staged[name] = [
                self._blob_tensor(self._shape_adapt(
                    src, dst.shape, f"layer {name!r} blob {i}"), dst)
                for i, (src, dst) in enumerate(zip(blobs, target))]
        for name, blobs in staged.items():
            self.params[name] = blobs

    # -- Caffe-format snapshots (Solver::Snapshot/Restore; reference:
    #    solver.cpp:447-530, sgd_solver.cpp:242-296) ------------------------
    def _history_flat(self) -> list[torch.Tensor]:
        """The rule's state in Caffe's history-blob order: one run of
        learnable-param-order blobs per slot (AdaDelta and Adam push a
        second run onto ``history_``; reference: adadelta_solver.cpp,
        adam_solver.cpp AdamPreSolve)."""
        return [b for slot in self._HISTORY_SLOTS[self.rule.name]
                for key in self.params for b in self.state[slot][key]]

    def snapshot_caffe(self, prefix: str | None = None) -> tuple[str, str]:
        """Write ``<prefix>_iter_N.caffemodel`` and ``.solverstate`` as
        Solver::Snapshot names them (reference: solver.cpp:461-476), the
        state recording the model file as ``learned_net``.  Returns the
        two paths."""
        from ..proto.caffemodel import save_caffemodel, save_solverstate
        if self.sp.snapshot_format == "HDF5":
            _refuse_hdf5("snapshot_format: HDF5")
        prefix = prefix if prefix is not None else self.sp.snapshot_prefix
        base = f"{prefix}_iter_{self.iter}"
        model_path, state_path = base + ".caffemodel", base + ".solverstate"
        save_caffemodel(model_path, self.params,
                        self.sp.net_param or self.sp.train_net_param)
        save_solverstate(state_path, self.iter, self._history_flat(),
                         learned_net=model_path)
        return model_path, state_path

    def restore_caffe(self, state_path: str) -> None:
        """Restore from a ``.solverstate`` and the ``learned_net`` model it
        names (reference: solver.cpp:510-530, sgd_solver.cpp:280-296).
        The history count and every shape are checked, and the model file
        must exist, before anything is written."""
        from ..proto.caffemodel import load_solverstate
        with open(state_path, "rb") as f:
            if f.read(4) == _HDF5_MAGIC:
                _refuse_hdf5(state_path)
        st = load_solverstate(state_path)
        history = st["history"]
        slots = self._HISTORY_SLOTS[self.rule.name]
        n_blobs = sum(len(v) for v in self.params.values())
        if len(history) != n_blobs * len(slots):
            raise ValueError(
                f"solverstate has {len(history)} history blobs, expected "
                f"{n_blobs * len(slots)} ({len(slots)} slot(s) x {n_blobs})")
        idx = 0
        new_state = {}
        for slot in slots:
            tree = {}
            for key, dsts in self.params.items():
                blobs = []
                for i, dst in enumerate(dsts):
                    src = self._shape_adapt(
                        history[idx], dst.shape,
                        f"history[{idx}] (layer {key!r} blob {i}, slot "
                        f"{slot!r})")
                    idx += 1
                    blobs.append(self._blob_tensor(src, dst))
                tree[key] = blobs
            new_state[slot] = tree
        if st["learned_net"]:
            # Caffe dies on an unreadable model file
            # (ReadNetParamsFromBinaryFileOrDie): optimizer history over
            # fresh weights would diverge silently
            if not os.path.exists(st["learned_net"]):
                raise FileNotFoundError(
                    f"solverstate references learned_net "
                    f"{st['learned_net']!r}, which does not exist")
            self.load_weights(st["learned_net"])
        self.state = new_state
        self.iter = st["iter"]
