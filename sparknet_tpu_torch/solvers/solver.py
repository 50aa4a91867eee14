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
pair Caffe writes, or with ``snapshot_format: HDF5`` the
``.caffemodel.h5`` + ``.solverstate.h5`` pair (``data/hdf5.py``, the
port's own HDF5 reader and writer; restore sniffs the magic);
``load_weights`` reads npz, ``.caffemodel`` (V1 zoo files included) or
``.caffemodel.h5``.  ``debug_info`` prints the JAX Solver's ``[Forward]``
and ``[Update]`` lines (mean |x| of every top blob and param) at each
display boundary.  Params shared across layers (``ParamSpec.name``) are
stored once, by their owner (``graph/net.py``): weight files are read
through the sharing map and written with every layer's full blob list,
as Caffe writes them.  ``set_augment`` runs Caffe's DataTransformer on
the raw uint8 feed (``records_feed(raw=True)``) in front of each step:
``ops/augment.py`` on the device, or its numpy half on the host, the
same bits either way.
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


def _test_net_specs(sp: SolverParameter, net_param
                    ) -> list[tuple[Any, NetState]]:
    """(NetParameter, NetState) of each test net (Solver::InitTestNets,
    solver.cpp:104-172): every ``test_net_param`` entry, else the shared
    net, in phase TEST.  With ``test_state``s, one net a state, the
    shared net making up the rest, each state's level and stages merged
    over the net's own."""
    if not sp.test_state:
        return [(tp, NetState(Phase.TEST))
                for tp in (list(sp.test_net_param) or [net_param])]
    n = len(sp.test_state)
    if n < len(sp.test_net_param):
        raise ValueError(f"{n} test_state entries for "
                         f"{len(sp.test_net_param)} test nets "
                         f"(solver.cpp CHECK_EQ test_state_size)")
    specs = list(sp.test_net_param) + [net_param] * (
        n - len(sp.test_net_param))
    return [(tp, NetState(Phase.TEST, ts.level or tp.state.level,
                          list(tp.state.stage) + list(ts.stage)))
            for tp, ts in zip(specs, sp.test_state)]


class Solver:
    """Owns the params and the update rule's state on ``device``, the
    iteration count, the Dropout generator and the test nets.

    ``Solver(sp, seed=None, device="cuda", compute_dtype=None)``: the net
    is ``sp.net_param`` or ``sp.train_net_param`` in the TRAIN phase; the
    test nets are one per ``sp.test_net_param`` entry, else the shared
    net in the TEST phase (Solver::InitTestNets precedence,
    solver.cpp:104-172), and every one is evaluated.  With
    ``test_state``s there is one test net a state, the shared net making
    up those the ``test_net_param`` entries do not, each filtered by its
    phase TEST, level and stages (``InitTestNets``; the test nets of
    examples/mnist/mnist_autoencoder_solver.prototxt).  A test net's
    layers that the train net lacks keep their filler init.  ``seed``
    defaults to ``sp.random_seed`` when set, else 0.
    """

    _HISTORY_SLOTS = {
        "SGD": ("history",), "NESTEROV": ("history",),
        "ADAGRAD": ("history",), "RMSPROP": ("history",),
        "ADADELTA": ("sq_grad", "sq_update"), "ADAM": ("m", "v"),
    }

    def __init__(self, sp: SolverParameter, *, seed: int | None = None,
                 device: str | torch.device = "cuda",
                 compute_dtype: torch.dtype | None = None):
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
        self.test_nets = [Net(tp, st, compute_dtype=compute_dtype)
                          for tp, st in _test_net_specs(sp, net_param)]
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
        # the crop offsets and flips of set_augment draw from a generator
        # of their own, saved with the Dropout one
        self.augment_generator = torch.Generator().manual_seed(
            seed * 7919 + 3)
        self._augment = None    # (spec, on the device?, blob, device spec)
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
        """Run Caffe's DataTransformer (``ops.augment.AugmentSpec``:
        crop, mirror, mean, scale) on the train feed's ``blob`` in front
        of each step, so the feed ships raw uint8
        (``records_feed(raw=True)``) and has no host transform.

        ``device=True`` (default: the ``SPARKNET_AUG_DEVICE`` knob, on)
        runs ``ops.augment.augment_batch`` on the Solver's device;
        ``device=False`` runs ``data.transforms.augment_batch_host`` on
        the host.  Both draw from ``augment_generator`` (saved by
        ``snapshot``), and give the same bits.  ``spec=None`` removes
        the augmentation."""
        from ..utils import knobs
        if device is None:
            device = knobs.get_bool("SPARKNET_AUG_DEVICE", True)
        if spec is None:
            self._augment = None
            return
        dev_spec = spec
        if device and spec.mean is not None:
            # the mean goes to the device once, not every step
            dev_spec = spec._replace(mean=torch.from_numpy(
                np.array(spec.mean, np.float32)).to(self.device))
        self._augment = (spec, bool(device), blob, dev_spec)

    def _augmented(self, blobs: list) -> torch.Tensor:
        """The ``iter_size`` minibatches of the augmented blob, flattened
        into one batch, augmented with one draw and restacked (the JAX
        Solver's step, solver.py:159-165)."""
        from ..data.transforms import augment_batch_host
        from ..ops.augment import augment_batch
        spec, on_device, _, dev_spec = self._augment
        i = len(blobs)
        if on_device:
            data = torch.stack([self._to_device(b) for b in blobs])
            flat = data.reshape((-1,) + tuple(data.shape[2:]))
            out = augment_batch(flat, self.augment_generator, dev_spec)
        else:
            data = np.stack([b.cpu().numpy() if isinstance(b, torch.Tensor)
                             else np.asarray(b) for b in blobs])
            flat = data.reshape((-1,) + data.shape[2:])
            out = self._to_device(augment_batch_host(
                flat, self.augment_generator, spec))
        return out.reshape((i, -1) + tuple(out.shape[1:]))

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
        aug = self._augment[2] if self._augment is not None else None
        return {k: self._augmented([b[k] for b in batches]) if k == aug
                else torch.stack([self._to_device(b[k]) for b in batches])
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
            debug = self.sp.debug_info and (
                not self.sp.display or (self.iter + 1) % self.sp.display == 0)
            if debug:
                # the rule updates in place: keep the params the step
                # starts from, and the Dropout draws it will make
                before = {k: [b.clone() for b in v]
                          for k, v in self.params.items()}
                gen_state = self.generator.get_state()
            with self._precision():
                self.params, self.state, loss = self._local_update(
                    self.params, self.state, self.iter, batches,
                    self.generator)
            # the loss stays on the device: smoothed_loss() fetches the
            # window, so the host waits only at display boundaries and at
            # the end of the call
            self._smoothed.append(loss)
            self.iter += 1
            if debug:
                self._log_debug_info(batches, before, gen_state)
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

    def _log_debug_info(self, batches, before: Params, gen_state) -> None:
        """The ``debug_info`` dumps (Caffe's ForwardDebugInfo and
        UpdateDebugInfo, net.cpp:711-735; the JAX Solver's
        ``_log_debug_info``, solver.py:357-380): the step's forward again
        on its first micro-batch with the params it started from and the
        same Dropout draws, one ``[Forward]`` line per top blob, then one
        ``[Update]`` line per param with the mean |x| of its value and of
        its change."""
        def asum(v: torch.Tensor) -> float:
            return float(v.float().abs().mean())

        gen = torch.Generator()
        gen.set_state(gen_state)
        first = {k: v[0] for k, v in batches.items()}
        with torch.no_grad(), self._precision():
            blobs = self.train_net.apply_all(before, first, train=True,
                                             generator=gen,
                                             device=self.device)
        for node in self.train_net.nodes:
            for t in node.tops:
                if t in blobs:
                    print(f"    [Forward] Layer {node.lp.name}, "
                          f"top blob {t} data: {asum(blobs[t]):.6g}")
        for key, old in before.items():
            for i, (b, a) in enumerate(zip(old, self.params[key])):
                print(f"    [Update] Layer {key}, param {i} "
                      f"data: {asum(a):.6g}; diff: {asum(a - b):.6g}")

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
        ``torch_generator`` and ``set_augment``'s under
        ``augment_generator`` (which the JAX package ignores)."""
        from ..utils.checkpoint import save_checkpoint
        save_checkpoint(path, {
            "params": self.params, "state": self.state, "iter": self.iter,
            "torch_generator": self.generator.get_state().numpy(),
            "augment_generator":
                self.augment_generator.get_state().numpy()})

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
        for key, gen in (("torch_generator", self.generator),
                         ("augment_generator", self.augment_generator)):
            if key in blob:
                gen.set_state(torch.from_numpy(np.array(blob[key],
                                                        np.uint8)))

    # -- weights (Net::CopyTrainedLayersFrom; reference: net.cpp:805-848) ---
    def load_weights(self, path: str) -> None:
        """Copy the blobs of a weight file into the layers of the same
        name, leaving the rest initialized.  The file type is sniffed: npz
        (``PK``: a checkpoint's ``params``, or a bare weight tree), HDF5
        (a ``.caffemodel.h5``, CopyTrainedLayersFromHDF5, net.cpp:
        889-924), else a binary ``.caffemodel`` (V1 zoo files
        included).  Raises on a file that carries no weights and on a
        blob count or shape the net does not accept."""
        with open(path, "rb") as f:
            magic = f.read(4)
        if magic == _HDF5_MAGIC:
            from ..data.hdf5 import load_model_hdf5
            saved = load_model_hdf5(path)
        elif magic[:2] == b"PK":
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
        by_name = {n.lp.name: n for n in self.train_net.nodes}
        # (storage key, stored position) -> the new blob; a sharer's
        # blobs go to their owner's place, the last write winning, as
        # Caffe copies through the shared pointer
        staged: dict[tuple[str, int], torch.Tensor] = {}
        for name, blobs in saved.items():
            node = by_name.get(name)
            if node is None:
                continue
            target = self.train_net.node_params(self.params, node)
            blobs = list(blobs)
            if not target and not blobs:
                continue
            if len(blobs) != len(target):
                raise ValueError(
                    f"layer {name!r}: checkpoint has {len(blobs)} blobs, "
                    f"net expects {len(target)}")
            for i, (src, dst) in enumerate(zip(blobs, target)):
                ref = node.shared_refs.get(i)
                place = ref if ref is not None else (
                    name, node.own_map[i] if node.shared_refs else i)
                staged[place] = self._blob_tensor(self._shape_adapt(
                    src, dst.shape, f"layer {name!r} blob {i}"), dst)
        for (key, pos), blob in staged.items():
            self.params[key] = list(self.params[key])
            self.params[key][pos] = blob

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
        Solver::Snapshot names them (reference: solver.cpp:461-476), or
        the ``.caffemodel.h5`` and ``.solverstate.h5`` pair when
        ``snapshot_format: HDF5`` (solver.cpp:449-459, sgd_solver.cpp:
        275-298), the state recording the model file as ``learned_net``.
        Returns the two paths."""
        from ..proto.caffemodel import save_caffemodel, save_solverstate
        prefix = prefix if prefix is not None else self.sp.snapshot_prefix
        base = f"{prefix}_iter_{self.iter}"
        hdf5 = self.sp.snapshot_format == "HDF5"
        model_path = base + (".caffemodel.h5" if hdf5 else ".caffemodel")
        state_path = base + (".solverstate.h5" if hdf5 else ".solverstate")
        # Net::ToProto writes every layer with its full blob list (a
        # sharer repeats its owner's), which CopyTrainedLayersFrom's blob
        # count check needs
        full = self.train_net.full_params(self.params)
        if hdf5:
            from ..data.hdf5 import save_model_hdf5, save_state_hdf5
            save_model_hdf5(model_path, {
                k: [b.detach().cpu().numpy() for b in v]
                for k, v in full.items() if v})
            save_state_hdf5(state_path, self.iter, [
                b.detach().cpu().numpy() for b in self._history_flat()],
                learned_net=model_path)
        else:
            save_caffemodel(model_path, full,
                            self.sp.net_param or self.sp.train_net_param)
            save_solverstate(state_path, self.iter, self._history_flat(),
                             learned_net=model_path)
        return model_path, state_path

    def restore_caffe(self, state_path: str) -> None:
        """Restore from a ``.solverstate`` or ``.solverstate.h5`` and the
        ``learned_net`` model it names (reference: solver.cpp:510-530,
        sgd_solver.cpp:280-296, :321-338 for HDF5, told apart by the
        magic).  The history count and every shape are checked, and the
        model file must exist, before anything is written."""
        from ..data.hdf5 import is_hdf5_file, load_state_hdf5
        from ..proto.caffemodel import load_solverstate
        st = (load_state_hdf5(state_path) if is_hdf5_file(state_path)
              else load_solverstate(state_path))
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
