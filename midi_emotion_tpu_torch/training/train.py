"""Training runtime, in torch (the reference's ``Runner``, train.py:31-473).

Counterpart of ``midi_emotion_tpu/training/train.py``, with the same
cadences: generation of the four fixed V/A corners every ``gen_step``,
logging and checkpointing every ``log_step``, evaluation every
``eval_step`` with the optional plateau LR, ``find_lr`` and resume from a
work dir of either layout (``--restart_dir``: the reference's, or a native
dir the JAX package trained, with its Adam state). The step is
``train_step.make_train_step``, on the card unless ``--device`` says
otherwise.

Under torchrun (``WORLD_SIZE`` > 1) the Runner starts the process group
(NCCL on cards, each rank on ``cuda:LOCAL_RANK``; gloo on the CPU; a caller
may start it first with another backend) and lays the ranks on the
(``--mesh_data``, ``--mesh_model``, ``--mesh_seq``) mesh
(``parallel/mesh.py``). Every rank builds the loader and the model from
the same seed and takes its rows of each global batch; the model is cut to
the rank's tensor-parallel shards, and with ``--mesh_seq`` > 1
(``--attn_impl ring``) its layers run on the rank's positions. Losses,
grad norms, eval metrics and ``performance.csv`` are the global batch's.
Only rank 0 writes the work dir, its logs and checkpoints (whole, in the
layout one process writes; ``--restart_dir`` is cut to the mesh again) and
generates the corner samples, with the whole model; the other ranks wait
at a barrier. ``--remat`` resolves as in the JAX Runner
(``models.model.resolve_remat``) into the run's config, a restarted
run's too, whatever the config it loads holds: recomputation changes no
result, only memory and time (the JAX Runner keeps a loaded config's
remat). ``--profile_dir`` writes a
``torch.profiler`` trace of ``--profile_steps`` steps from rank 0.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time

import numpy as np
import torch

from ..data.features import preprocess_features
from ..data.loader import Loader, LoaderExhaustive, LoaderGenerations
from ..models.config import ModelConfig
from ..models.model import MusicTransformer, resolve_device, resolve_remat
from ..ops.attention import resolve_attn_impl
from ..parallel import mesh as mesh_lib
from ..vocab import Vocab
from . import checkpoint as ckpt
from .metrics import CsvWriter, create_exp_dir
from .schedulers import LRController
from .train_step import make_eval_step, make_optimizer, make_train_step

CSV_FIELDS = ["epoch", "step", "hour", "lr", "trn_loss", "val_loss", "val_l1_v", "val_l1_a"]


def _quiet(*args, **kwargs) -> None:
    """The logger of ranks other than 0."""


class Runner:
    def __init__(self, args):
        self.args = args
        self.device = mesh_lib.rank_device(resolve_device(args.device))
        mesh_lib.initialize_distributed("nccl" if self.device.type == "cuda" else "gloo")
        self.mesh = mesh_lib.make_mesh(n_data=args.mesh_data, n_model=args.mesh_model,
                                       n_seq=args.mesh_seq)
        self.main = self.mesh.rank == 0
        self.logging = create_exp_dir(args.work_dir, debug=args.debug) if self.main else _quiet
        name = torch.cuda.get_device_name(self.device) if self.device.type == "cuda" else "cpu"
        self.logging(f"Device: {self.device} ({name})")
        n_data, n_seq = self.mesh.shape["data"], self.mesh.shape["seq"]
        self.logging(f"Mesh: data={n_data} model={self.mesh.shape['model']} seq={n_seq}")
        if args.batch_size % n_data:
            raise ValueError(f"--batch_size {args.batch_size} must be divisible by the data "
                             f"mesh size {n_data} (set --mesh_data)")
        if (args.attn_impl == "ring") != (n_seq > 1):
            raise ValueError("--attn_impl ring and --mesh_seq > 1 go together: the ring runs "
                             "over the seq mesh axis")
        if args.tgt_len % n_seq:
            # the model-internal T is tgt_len in every conditioning mode (the
            # continuous_token loader shortens its input by the 2-slot prefix)
            raise ValueError(f"--tgt_len {args.tgt_len} must be divisible by the seq mesh "
                             f"axis ({n_seq})")

        self.train_step_num = 0
        self.n_sequences_total = 0
        self.init_hours = 0.0
        self.epoch = 0
        self.init_time = time.time()

        n_bins = (
            args.n_emotion_bins
            if args.conditioning == "discrete_token" and not args.regression
            else None
        )
        conditional = args.conditioning != "none" or args.regression

        train_feats, test_feats = preprocess_features(
            args.feature_file,
            n_bins=n_bins,
            conditional=conditional,
            use_labeled_only=not args.full_dataset,
        )

        max_samples = args.n_samples if args.n_samples > 0 else None
        common = dict(
            regression=args.regression,
            always_use_discrete_condition=args.always_use_discrete_condition,
        )
        pad = not args.no_pad
        if args.exhaustive_eval:
            self.train_dataset = None
            self.test_dataset = LoaderExhaustive(
                args.data_folder, test_feats, args.tgt_len, args.conditioning,
                max_samples=max_samples, pad=pad, **common,
            )
        else:
            self.train_dataset = Loader(
                args.data_folder, train_feats, args.tgt_len, args.conditioning,
                max_samples=max_samples, overfit=args.overfit,
                bar_start_prob=args.bar_start_prob, pad=pad,
                max_transpose=args.max_transpose, seed=max(args.seed, 0), **common,
            )
            self.test_dataset = Loader(
                args.data_folder, test_feats, args.tgt_len, args.conditioning,
                max_samples=max_samples, pad=pad,
                seed=max(args.seed, 0) + 1, **common,
            )
        if args.regression_dir is not None:
            self.train_dataset = None
            self.test_dataset = LoaderGenerations(args.regression_dir, args.tgt_len)

        self.vocab: Vocab = (
            self.train_dataset.vocab if self.train_dataset else self.test_dataset.vocab
        )
        self.logging(f"Number of tokens: {len(self.vocab)}")

        # ---- model: f32 master parameters, compute in --dtype ------------
        dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
        remat = resolve_remat(args.remat, resolve_attn_impl(args.attn_impl, self.device))
        remat_fields = dict(remat=remat != "none",
                            remat_policy=remat if remat != "none" else "dots")
        self.restart_dir = args.restart_dir
        if self.restart_dir:
            from ..convert import load_model_dir

            self.cfg, self.model, _ = load_model_dir(
                self.restart_dir, dtype=dtype, device=self.device,
                attn_impl=args.attn_impl, param_dtype=torch.float32)
            if args.overwrite_dropout:
                # build_model.py:43-47: reset dropout when reloading
                self.cfg = dataclasses.replace(self.cfg, dropout=args.dropout)
                for layer in self.model.enc_layers:
                    layer.dropout = args.dropout
                self.logging(f"Dropout rate changed to {args.dropout}")
            # recomputation changes no result: --remat, auto too, is this
            # run's choice, whatever the loaded config holds (a reference
            # dir's holds none, a native dir's the choice of the run or
            # conversion that wrote it)
            self.cfg = dataclasses.replace(self.cfg, **remat_fields)
            self.model.config = self.cfg
            self.csv_in = os.path.join(self.restart_dir, "performance.csv")
        else:
            self.cfg = ModelConfig(
                vocab_size=len(self.vocab),
                mode="regression" if args.regression else args.conditioning,
                n_layer=args.n_layer,
                n_head=args.n_head,
                d_model=args.d_model,
                d_inner=args.d_inner,
                d_condition=args.d_condition,
                dropout=args.dropout,
                max_seq=max(args.max_seq, args.tgt_len),
                pad_id=self.vocab.pad_id,
                **remat_fields,
            ).validate()
            self.model = MusicTransformer(
                self.cfg, dtype=dtype, device=self.device, attn_impl=args.attn_impl,
                param_dtype=torch.float32,
            ).init_weights(torch.Generator().manual_seed(max(args.seed, 0)))
            self.csv_in = None
        self.model.train()
        remat = self.cfg.remat_policy if self.cfg.remat else "none"
        self.logging(f"compute dtype: {args.dtype}, parameters f32, remat {remat}")

        n_params = sum(p.numel() for p in self.model.parameters())
        self.logging(f"#params = {n_params}")

        # ---- optimizer + schedules ---------------------------------------
        self.optimizer = make_optimizer(self.model)
        self.lr_ctrl = LRController(
            args.scheduler, args.lr, warmup_step=args.warmup_step,
            max_step=args.max_step, lr_min=args.lr_min, lr_max=args.lr_max,
            decay_rate=args.decay_rate, patience=args.patience,
        )

        if self.restart_dir:  # read whole, then cut to the mesh below
            if not ckpt.load_opt_state(self.restart_dir, self.optimizer, self.model):
                self.logging(f"no optimizer state in {self.restart_dir} fits: Adam starts afresh")
            stats = ckpt.load_stats(self.restart_dir)
            self.train_step_num = stats["step"]
            self.init_hours = stats["hour"]
            self.epoch = stats["epoch"]
            self.n_sequences_total = stats["sample"]
            if args.overwrite_lr:
                self.lr_ctrl.base_lr = args.lr

        if self.mesh.size > 1:
            self.model.parallelize(self.mesh)
            self._shard_optimizer()

        self._train_fn = make_train_step(
            self.model, self.optimizer, args.clip, accumulate_steps=args.accumulate_step
        )
        self._eval_fn = make_eval_step(self.model)
        # draws every step's dropout seeds
        self._generator = torch.Generator().manual_seed(max(args.seed, 0) + 17)

        self._save()
        self.csv_writer = CsvWriter(
            os.path.join(args.work_dir, "performance.csv"),
            CSV_FIELDS, in_path=self.csv_in, debug=args.debug or not self.main,
        )
        self.gen_dir = os.path.join(args.work_dir, "generations", "training")

    # ------------------------------------------------------------------
    def _shard_optimizer(self) -> None:
        """Cut the Adam moments of each sharded parameter to this rank's
        slice, as ``parallelize`` cut the parameter."""
        for name, p in self.model.named_parameters():
            state = self.optimizer.state.get(p)
            dim = self.model.shard_dims[name]
            if state and dim is not None:
                for key in ("exp_avg", "exp_avg_sq"):
                    state[key] = mesh_lib.local_part(state[key], dim, self.mesh)

    def _whole(self, with_optimizer: bool = False):
        """(model, optimizer or None) as one process holds them: the Runner's
        own off a tensor-parallel or seq mesh axis, else a new model with
        the shards gathered (every rank must call this) and attention that
        runs on one device."""
        if self.mesh.shape["model"] == 1 and self.mesh.shape["seq"] == 1:
            return self.model, self.optimizer if with_optimizer else None
        dims = self.model.shard_dims
        whole = MusicTransformer(self.cfg, dtype=self.model.dtype, device=self.device,
                                 param_dtype=self.model.param_dtype)
        named = list(self.model.named_parameters())
        with torch.no_grad():
            for (name, p), w in zip(named, whole.parameters()):
                w.copy_(mesh_lib.gather_whole(p.detach(), dims[name], self.mesh))
        if not with_optimizer:
            return whole, None
        state = self.optimizer.state_dict()
        state["state"] = {i: dict(st) for i, st in state["state"].items()}  # not the live dicts
        for i, (name, _) in enumerate(named):
            st = state["state"].get(i)
            if st:
                for key in ("exp_avg", "exp_avg_sq"):
                    st[key] = mesh_lib.gather_whole(st[key], dims[name], self.mesh)
        optimizer = make_optimizer(whole)
        optimizer.load_state_dict(state)
        return whole, optimizer

    def _save(self, stats=None) -> None:
        """A checkpoint of the whole model (with the optimizer when
        ``stats`` is given), written by rank 0; the others wait."""
        args = self.args
        if args.debug:
            return
        model, optimizer = self._whole(with_optimizer=stats is not None)
        if self.main:
            ckpt.save_checkpoint(args.work_dir, model, self.cfg, self.vocab,
                                 optimizer=optimizer, stats=stats, clip=args.clip)
        mesh_lib.barrier(self.mesh)

    def _to_device(self, batch):
        """numpy batch -> this rank's rows as tensors on the device: token
        arrays as int64, conditions as f32."""
        leading_accum = batch["input"].ndim == 3
        out = {}
        for k, v in mesh_lib.shard_batch(batch, self.mesh, leading_accum).items():
            dtype = torch.float32 if k == "condition" else torch.long
            out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(self.device, dtype)
        return out

    def _microbatches(self, it):
        """Pull accumulate_step * batch_size samples -> leading accum axis."""
        a = self.args.accumulate_step
        batch = next(it)
        if a == 1:
            return {k: v[None] for k, v in batch.items()}
        parts = [batch] + [next(it) for _ in range(a - 1)]
        return {k: np.stack([p[k] for p in parts]) for k in batch}

    def evaluate(self):
        """Weighted-aggregate evaluation (train.py:222-274)."""
        args = self.args
        total = {}
        n_total = 0
        n_seq = 0
        for i, batch in enumerate(self.test_dataset.batches(args.batch_size)):
            if not args.exhaustive_eval and args.max_eval_step > 0 and i >= args.max_eval_step:
                break
            out = {k: v.item() for k, v in self._eval_fn(self._to_device(batch)).items()}
            n = int(out.pop("n_elements"))
            for k, v in out.items():
                total[k] = total.get(k, 0.0) + n * float(v)
            n_total += n
            n_seq += batch["input"].shape[0]
        if n_total == 0:
            return float("nan"), {}
        avg = {k: v / n_total for k, v in total.items()}
        loss = avg.pop("loss")
        if args.exhaustive_eval:
            self.logging(f"Total number of sequences: {n_seq}")
        return loss, avg

    def _generate_corners(self):
        """Fixed-corner sample generation during training
        (train.py:335-373), by rank 0 with the whole model."""
        model, _ = self._whole()
        if self.main:
            self._generate_with(model)
        mesh_lib.barrier(self.mesh)

    def _generate_with(self, model):
        args = self.args
        from ..generation.generate import generate

        max_input_len = (
            args.max_gen_input_len if args.max_gen_input_len > 0 else args.tgt_len
        )
        primers = [["<START>"]]
        discrete, continuous = None, None
        if args.conditioning == "none":
            primers = [["<START>"] for _ in range(4)]
        elif args.conditioning == "discrete_token":
            discrete = [["<V-2>", "<A-2>"], ["<V-2>", "<A2>"],
                        ["<V2>", "<A-2>"], ["<V2>", "<A2>"]]
        else:
            continuous = [[-0.8, -0.8], [-0.8, 0.8], [0.8, -0.8], [0.8, 0.8]]
        try:
            generate(
                model, self.vocab, self.gen_dir,
                args.conditioning, discrete_conditions=discrete,
                continuous_conditions=continuous, min_n_instruments=1,
                gen_len=args.gen_len, max_input_len=max_input_len,
                step=str(self.train_step_num), primers=primers,
                temperatures=[args.temp_note, args.temp_rest],
                debug=args.debug, verbose=False,
            )
        except KeyError:
            # discrete corner tokens absent from this run's vocabulary
            self.logging("skipping corner generation: condition tokens not in vocab")

    def _step(self, it, lr: float):
        batch = self._microbatches(it)
        metrics = self._train_fn(self._to_device(batch), lr, self._generator)
        return batch, float(metrics["loss"])

    def train(self):
        args = self.args
        from ..data.loader import prefetch

        if args.num_workers > 1 and not args.overfit:
            # real worker processes (the reference's num_workers=8,
            # train.py:87-93); overfit stays single-process so the cached
            # one-sample short-circuit keeps batches identical
            from ..data.loader import epochs_multiprocess

            it = epochs_multiprocess(
                self.train_dataset, args.batch_size,
                num_workers=args.num_workers, shuffle=not args.debug,
                seed=max(args.seed, 0),
            )
        else:
            it = self.train_dataset.epochs(args.batch_size, shuffle=not args.debug)
            if args.num_workers > 0:
                it = prefetch(it, size=4)
        train_loss = 0.0
        n_elements_total = 0
        interval_start = time.time()
        samples_per_epoch = max(1, len(self.train_dataset) // args.batch_size)
        steps_this_epoch = 0

        profiler = None
        while self.train_step_num < args.max_step:
            if args.profile_dir and self.main and self.train_step_num == args.profile_start:
                profiler = _start_profiler(self.device)
            if profiler and self.train_step_num == args.profile_start + args.profile_steps:
                self._stop_profiler(profiler)
                profiler = None
            lr = self.lr_ctrl.lr_at(self.train_step_num)
            batch, loss_val = self._step(it, lr)
            n_elements = int(np.prod(batch["input"].shape))
            if not math.isnan(loss_val):
                train_loss += n_elements * loss_val
                n_elements_total += n_elements
            self.n_sequences_total += int(
                batch["input"].shape[0] * batch["input"].shape[1]
            )

            step = self.train_step_num
            if step % args.gen_step == 0 and step > 0 and not args.regression:
                self._generate_corners()

            if step % args.log_step == 0 and n_elements_total > 0:
                cur_loss = train_loss / n_elements_total
                hours = self.init_hours + (time.time() - self.init_time) / 3600
                ms_per_batch = (time.time() - interval_start) * 1000 / args.log_step
                self.logging(
                    "| Epoch {:3d} step {:>8d} | {:>6d} sequences  | {:>3.1f} h "
                    "| lr {:.2e} | ms/batch {:4.0f} | loss {:7.4f}".format(
                        self.epoch, step, self.n_sequences_total, hours, lr,
                        ms_per_batch, cur_loss,
                    )
                )
                self.csv_writer.update(
                    {"epoch": self.epoch, "step": step, "hour": hours, "lr": lr,
                     "trn_loss": cur_loss, "val_loss": np.nan,
                     "val_l1_v": np.nan, "val_l1_a": np.nan}
                )
                train_loss, n_elements_total = 0.0, 0
                interval_start = time.time()
                self._save({"step": step, "hour": hours, "epoch": self.epoch,
                            "sample": self.n_sequences_total})

            if step % args.eval_step == 0 and not args.overfit:
                val_loss, val_acc = self.evaluate()
                hours = self.init_hours + (time.time() - self.init_time) / 3600
                self.logging("-" * 100)
                msg = (
                    "| Eval  {:3d} step {:>8d} | {:>3.1f} h | valid loss {:7.4f} "
                    "| ppl {:5.3f}".format(
                        step // max(args.eval_step, 1), step, hours, val_loss,
                        math.exp(min(val_loss, 20)) if not math.isnan(val_loss) else float("nan"),
                    )
                )
                if args.regression and val_acc:
                    msg += " | l1_v: {:5.3f} | l1_a: {:5.3f}".format(
                        val_acc["l1_v"], val_acc["l1_a"]
                    )
                self.logging(msg)
                self.logging("-" * 100)
                self.csv_writer.update(
                    {"epoch": self.epoch, "step": step, "hour": hours, "lr": lr,
                     "trn_loss": np.nan, "val_loss": val_loss}
                )
                self.lr_ctrl.on_eval(val_loss)

            self.train_step_num += 1
            steps_this_epoch += 1
            if steps_this_epoch >= samples_per_epoch:
                self.epoch += 1
                steps_this_epoch = 0

        if profiler:
            self._stop_profiler(profiler)

    def _stop_profiler(self, profiler) -> None:
        profiler.__exit__(None, None, None)
        os.makedirs(self.args.profile_dir, exist_ok=True)
        path = os.path.join(self.args.profile_dir, f"trace_step{self.train_step_num}.json")
        profiler.export_chrome_trace(path)
        self.logging(f"profiler trace written to {path}")

    def find_lr(
        self,
        lr_min: float = 1e-7,
        lr_max: float = 1.0,
        n_steps: int = 60,
        smooth: float = 0.8,
    ):
        """Exponential learning-rate sweep (the reference's --find_lr flag
        only toggles debug mode, config.py:137-138; this is a working one).
        Returns (lrs, losses, suggestion) where suggestion is the LR one
        decade below the divergence point."""
        args = self.args
        it = self.train_dataset.epochs(args.batch_size, shuffle=True)
        factor = (lr_max / lr_min) ** (1.0 / max(n_steps - 1, 1))
        lrs, losses = [], []
        best = float("inf")
        avg = 0.0
        lr = lr_min
        for i in range(n_steps):
            _, loss = self._step(it, lr)
            avg = smooth * avg + (1 - smooth) * loss
            debiased = avg / (1 - smooth ** (i + 1))
            lrs.append(lr)
            losses.append(debiased)
            best = min(best, debiased)
            if not math.isfinite(debiased) or debiased > 4 * best:
                break  # diverged
            lr *= factor
        suggestion = lrs[-1] / 10.0
        self.logging(
            f"LR finder: swept {len(lrs)} steps, diverged near {lrs[-1]:.2e}; "
            f"suggested lr ~ {suggestion:.2e}"
        )
        if not args.debug and self.main:
            with open(os.path.join(args.work_dir, "lr_finder.csv"), "w") as f:
                f.write("lr,loss\n")
                for l, v in zip(lrs, losses):
                    f.write(f"{l},{v}\n")
        return lrs, losses, suggestion

    def run(self):
        args = self.args
        try:
            if args.find_lr:
                return self.find_lr()
            if args.exhaustive_eval or args.regression_dir is not None:
                self.logging("Exhaustive evaluation")
                loss, accs = self.evaluate()
                msg = f"Loss: {loss:7.4f}, ppl: {math.exp(min(loss, 20)):5.2f}"
                for k, v in accs.items():
                    msg += f", {k}: {v:7.4f}"
                self.logging(msg)
                return loss, accs
            self.train()
            self.logging("End of training")
        except KeyboardInterrupt:
            self.logging("Exiting from training early")


def _start_profiler(device: torch.device):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    profiler.__enter__()
    return profiler
