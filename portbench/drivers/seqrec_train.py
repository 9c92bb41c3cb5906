"""Whole ``train_seqrec`` runs, back to back, each one epoch over every
user's history.

Configuration keys read: ``d_model``, ``n_heads``, ``n_layers``, ``ffn``,
``max_len``, ``n_items``, ``n_users``, ``learning_rate``.

Mix parameters: ``batch_size`` (histories a step), ``epochs`` (a run's
steps are this many passes over the users, in the port's contiguous
blocks with wraparound), ``len_min``, ``len_mean``, ``len_sigma``
(:func:`gen.lengths`) and ``zipf_s`` (:func:`gen.histories`). Each run
draws its own init and is fed the epoch in the port's documented order.
"""

from __future__ import annotations

import torch

from portbench import counts, gen
from portbench.reference import seqrec as ref
from portbench.reference.train import follow
from portbench.training import CHECK_STEPS, TrainDriver

#: histories a block of the reference's step (its logits stay a few GB)
REF_ROWS = 32


class Driver(TrainDriver):
    head = ref.HEAD

    def _cfg(self, run_seed: int, steps: int):
        from pio_tpu_torch.models.seqrec import SeqRecConfig

        c = self.config
        return SeqRecConfig(
            d_model=c["d_model"], n_heads=c["n_heads"],
            n_layers=c["n_layers"], ffn=c["ffn"], max_len=c["max_len"],
            learning_rate=c["learning_rate"], steps=steps, seed=run_seed,
            batch_size=self.mix["batch_size"])

    def inputs(self) -> None:
        c, m = self.config, self.mix
        lens = gen.lengths(gen.rng(self.seed, 1), c["n_users"], m["len_min"],
                           m["len_mean"], m["len_sigma"], c["max_len"])
        self.seqs = gen.histories(self.seed, lens, c["n_items"], m["zipf_s"],
                                  c["max_len"], self.device)
        self.vocab = c["n_items"] + 1
        self.n_batches, self._batch = ref.feed(self.seqs, m["batch_size"],
                                               c["max_len"])
        self.steps = int(m["epochs"]) * self.n_batches
        self.n_params = sum(
            int(torch.Size(s).numel()) for s in ref.shapes(
                self.vocab, c["d_model"], c["n_layers"], c["ffn"],
                c["max_len"]).values())

    def step_work(self, step: int):
        c = self.config
        seqs, _, _ = self._batch(step)
        lengths = (seqs > 0).sum(axis=1)
        flops = counts.seqrec_train_step_flops(
            lengths, c["d_model"], c["n_layers"], c["ffn"], self.vocab)
        nbytes = counts.adam_step_bytes(self.n_params) + 12 * seqs.size
        return flops, nbytes

    def train(self, run_seed: int, steps: int, tap, rows=None):
        from pio_tpu_torch.models.seqrec import train_seqrec

        return train_seqrec(None, self.seqs[:rows], self.config["n_items"],
                            self._cfg(run_seed, steps), checkpoint=tap,
                            checkpoint_every=1 if tap is not None else 0,
                            device=self.device)

    def reference(self, run_seed: int, tf32: bool = False,
                  half_batch: bool = False):
        c, dev = self.config, self.device
        p0 = ref.init_params(self.vocab, c["d_model"], c["n_layers"],
                             c["ffn"], c["max_len"], run_seed)

        def batch_of(step):
            return tuple(torch.from_numpy(a).to(dev)
                         for a in self._batch(step))

        return follow(p0, lambda p, b: ref.loss_sum(p, b, c["n_heads"]),
                      ref.count, batch_of, CHECK_STEPS, c["learning_rate"],
                      dev, tf32=tf32, half_batch=half_batch,
                      block_rows=REF_ROWS)
