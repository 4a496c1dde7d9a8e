"""Faults planted underneath a cell's timed path, to see its check fail.

Each function breaks the port where its work is produced, through
``patch(owner, name, value)`` (pytest's ``monkeypatch.setattr``, or the
restoring :class:`Patches` of ``calibrate.py``).  ``FAULTS`` lists those
that each kind of cell can have; a cell on one chip has no exchange
between chips to leave out.  ``CPU_ONLY`` names those that break a
step the card's path does not take (the card decodes pages in its
kernel, not in the plain step): the CPU tests plant them, and a
calibration on the card refuses them.
"""
from __future__ import annotations

import numpy as np


def state_unchanged_decode(patch):
    """The decode's LSTM step returns its state unchanged (the plain
    version's step: the CPU path, and the path the card takes where
    no kernel layout fits)."""
    from ocrd_keraslm_torch.ops import decode_kernel as dk
    plain = dk._char_step

    def step(stateE, chars, *a):
        _, nll2 = plain(stateE, chars, *a)
        return stateE, nll2
    patch(dk, '_char_step', step)


def token_altered_decode(patch):
    """A page group's walk returns, for its first edge not decoded to
    the first alternative, the first alternative."""
    from ocrd_keraslm_torch.rater import Rater
    plain = Rater.rate_best_device_finish_group

    def finish(pending, i):
        choices, costs, start = plain(pending, i)
        choices = choices.copy()
        k = int(np.flatnonzero(choices)[0])
        choices[k] = 0
        return choices, costs, start
    patch(Rater, 'rate_best_device_finish_group', staticmethod(finish))


def state_unchanged_generate(patch):
    """Generation's LSTM stack step (prompt steps; the plain version of
    the beam) returns its state unchanged."""
    from ocrd_keraslm_torch.ops import beam_device
    plain = beam_device._gen_layers

    def layers(emb, embT, wcat, bias, v_real, state):
        _, logits = plain(emb, embT, wcat, bias, v_real, state)
        return state[:, emb.shape[1]:], logits
    patch(beam_device, '_gen_layers', layers)


def token_altered_generate(patch):
    """The sixth char of every returned string is another one."""
    from ocrd_keraslm_torch.ops import beam_device
    plain = beam_device.generate_beam_finish

    def finish(pending):
        return [s[:5] + ('e' if s[5] != 'e' else 'n') + s[6:]
                for s in plain(pending)]
    patch(beam_device, 'generate_beam_finish', finish)


def state_unchanged_train(patch):
    """The training step leaves the weights as they were."""
    import torch
    from ocrd_keraslm_torch import training
    plain = training.train_step

    def step(params, optimizer, *a, **kw):
        saved = [p.detach().clone() for p in training.param_leaves(params)]
        out = plain(params, optimizer, *a, **kw)
        with torch.no_grad():
            for p, s in zip(training.param_leaves(params), saved):
                p.copy_(s)
        return out
    patch(training, 'train_step', step)


def half_batch_train(patch):
    """The training step leaves out the second half of the batch (the
    mean taken over the rest)."""
    from ocrd_keraslm_torch import training
    plain = training.train_step

    def step(params, optimizer, cfg, x, zs, y, mask, *a, **kw):
        mask = mask.clone()
        mask[mask.shape[0] // 2:] = 0.0
        return plain(params, optimizer, cfg, x, zs, y, mask, *a, **kw)
    patch(training, 'train_step', step)


CPU_ONLY = ('state_unchanged_decode',)

FAULTS = {
    'decode': (state_unchanged_decode, token_altered_decode),
    'generate': (state_unchanged_generate, token_altered_generate),
    'train': (state_unchanged_train, half_batch_train),
}
