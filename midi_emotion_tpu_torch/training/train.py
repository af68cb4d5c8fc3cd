"""Training runtime, in torch (the reference's ``Runner``, train.py:31-473).

Counterpart of ``midi_emotion_tpu/training/train.py``, with the same
cadences: generation of the four fixed V/A corners every ``gen_step``,
logging and checkpointing every ``log_step``, evaluation every
``eval_step`` with the optional plateau LR, ``find_lr`` and resume. The
step is ``train_step.make_train_step`` on one device, the card unless
``--device`` says otherwise.

There is no mesh: ``--mesh_data``/``--mesh_model``/``--mesh_seq`` other
than 1, ``--attn_impl ring`` and ``--remat dots|full`` raise
NotImplementedError, each naming its ROADMAP item. ``--profile_dir``
writes a ``torch.profiler`` trace of ``--profile_steps`` steps.
"""

from __future__ import annotations

import math
import os
import time

import numpy as np
import torch

from ..data.features import preprocess_features
from ..data.loader import Loader, LoaderExhaustive, LoaderGenerations
from ..models.config import ModelConfig
from ..models.model import MusicTransformer, resolve_device
from ..vocab import Vocab
from . import checkpoint as ckpt
from .metrics import CsvWriter, create_exp_dir
from .schedulers import LRController
from .train_step import make_eval_step, make_optimizer, make_train_step

CSV_FIELDS = ["epoch", "step", "hour", "lr", "trn_loss", "val_loss", "val_l1_v", "val_l1_a"]


def _check_unported(args) -> None:
    meshes = {"--mesh_data": args.mesh_data, "--mesh_model": args.mesh_model,
              "--mesh_seq": args.mesh_seq}
    for flag, n in meshes.items():
        if n not in (None, 1):
            raise NotImplementedError(
                f"{flag} {n}: the torch port has no device mesh yet (ROADMAP queue 1, "
                "item 5: data, tensor and ring-attention parallelism)")
    if args.attn_impl == "ring":
        raise NotImplementedError(
            "--attn_impl ring: ring attention is not ported yet (ROADMAP queue 1, item 5)")
    if args.remat not in ("auto", "none"):
        raise NotImplementedError(
            f"--remat {args.remat}: activation recomputation is not ported (ROADMAP "
            "queue 1, item 2 notes: the flash kernels keep attention O(T) in memory, "
            "so the flagship trains without it)")


class Runner:
    def __init__(self, args):
        _check_unported(args)
        self.args = args
        self.device = resolve_device(args.device)
        self.logging = create_exp_dir(args.work_dir, debug=args.debug)
        name = torch.cuda.get_device_name(self.device) if self.device.type == "cuda" else "cpu"
        self.logging(f"Device: {self.device} ({name})")

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
        self.logging(f"compute dtype: {args.dtype}, parameters f32")
        self.restart_dir = args.restart_dir
        if self.restart_dir:
            from ..convert import load_model_dir

            self.cfg, self.model, _ = load_model_dir(
                self.restart_dir, dtype=dtype, device=self.device,
                attn_impl=args.attn_impl, param_dtype=torch.float32)
            if args.overwrite_dropout:
                # build_model.py:43-47: reset dropout when reloading
                import dataclasses

                self.cfg = dataclasses.replace(self.cfg, dropout=args.dropout)
                self.model.config = self.cfg
                for layer in self.model.enc_layers:
                    layer.dropout = args.dropout
                self.logging(f"Dropout rate changed to {args.dropout}")
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
                remat=False,
            ).validate()
            self.model = MusicTransformer(
                self.cfg, dtype=dtype, device=self.device, attn_impl=args.attn_impl,
                param_dtype=torch.float32,
            ).init_weights(torch.Generator().manual_seed(max(args.seed, 0)))
            self.csv_in = None
        self.model.train()

        n_params = sum(p.numel() for p in self.model.parameters())
        self.logging(f"#params = {n_params}")

        # ---- optimizer + schedules ---------------------------------------
        self.optimizer = make_optimizer(self.model)
        self.lr_ctrl = LRController(
            args.scheduler, args.lr, warmup_step=args.warmup_step,
            max_step=args.max_step, lr_min=args.lr_min, lr_max=args.lr_max,
            decay_rate=args.decay_rate, patience=args.patience,
        )

        if self.restart_dir:
            ckpt.load_opt_state(self.restart_dir, self.optimizer)
            stats = ckpt.load_stats(self.restart_dir)
            self.train_step_num = stats["step"]
            self.init_hours = stats["hour"]
            self.epoch = stats["epoch"]
            self.n_sequences_total = stats["sample"]
            if args.overwrite_lr:
                self.lr_ctrl.base_lr = args.lr

        self._train_fn = make_train_step(
            self.model, self.optimizer, args.clip, accumulate_steps=args.accumulate_step
        )
        self._eval_fn = make_eval_step(self.model)
        # draws every step's dropout seeds
        self._generator = torch.Generator().manual_seed(max(args.seed, 0) + 17)

        if not args.debug:
            ckpt.save_checkpoint(args.work_dir, self.model, self.cfg, self.vocab)
        self.csv_writer = CsvWriter(
            os.path.join(args.work_dir, "performance.csv"),
            CSV_FIELDS, in_path=self.csv_in, debug=args.debug,
        )
        self.gen_dir = os.path.join(args.work_dir, "generations", "training")

    # ------------------------------------------------------------------
    def _to_device(self, batch):
        """numpy batch -> tensors on the device: token arrays as int64,
        conditions as f32."""
        out = {}
        for k, v in batch.items():
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
        (train.py:335-373)."""
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
                self.model, self.vocab, self.gen_dir,
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
            if args.profile_dir and self.train_step_num == args.profile_start:
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
                if not args.debug:
                    ckpt.save_checkpoint(
                        args.work_dir, self.model, self.cfg, self.vocab,
                        optimizer=self.optimizer,
                        stats={"step": step, "hour": hours, "epoch": self.epoch,
                               "sample": self.n_sequences_total},
                    )

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
        if not args.debug:
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
