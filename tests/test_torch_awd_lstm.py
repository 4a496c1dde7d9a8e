"""AWD-LSTM's shape in the port (``models/lstm_lm.LMConfig``'s ``widths``,
``head_bias``, ``weight_drop`` and the three locked dropouts) against the plain reference ``tests/awd_lstm_reference.py``, on
the CPU at a small size of unequal widths (embedding 12, layers 24/24/12,
V 9, B 3, T 7), with AWD's dropouts and weight drop on (the masks
replayed from the trainer's generator, ``trainer_masks``) and off.

Tolerances, each with its reason:

* logits and loss: the port and the reference run the same float32
  operations per step (one product for each layer's input projection, one
  for the recurrence a step, the same gate order), so they differ by the
  summation order of a few products at most: logits atol 1e-6 (values of
  order 1; bfloat16 products move them by ~1e-2), loss rtol 1e-6;
* gradients: the port's backward (``lstm_bwd_ref``) and autograd through
  the reference's loop add the same terms in another order: max abs
  difference at most 2e-6 of the leaf's largest gradient (measured: 2.2e-7
  at worst; bfloat16 products: 1.7e-5 at best, the head bias, 4e-4 to 5e-3
  the others);
* three Adam steps: each leaf's change at most 1e-7 off the reference's
  (measured: 3e-8 at worst, f32 rounding of changes up to 3e-3 = three
  steps of lr; bfloat16 products: 1e-5 to 2e-3 for every leaf but the head
  bias).
"""
import os

import numpy as np
import pytest
import torch

import awd_lstm_reference as ref
from ocrd_keraslm_torch import training
from ocrd_keraslm_torch.models import lstm_lm as lm
from ocrd_keraslm_torch.ops.score_kernel import pack_score_weights
from ocrd_keraslm_torch.rater import Rater
from ocrd_keraslm_torch.utils import h5io
from ocrd_keraslm_torch.utils.vocab import Vocab

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E, WIDTHS, V, B, T = 12, (24, 24, 12), 9, 3, 7
RATES = {'weight_drop': 0.2, 'dropout_input': 0.1, 'dropout_hidden': 0.1,
         'dropout_output': 0.4}
LOGIT_ATOL, LOSS_RTOL = 1e-6, 1e-6
GRAD_OF_MAX, UPDATE_ATOL = 2e-6, 1e-7


def awd_cfg(on: bool) -> lm.LMConfig:
    return lm.LMConfig(width=E, depth=3, voc_size=V, contexts=(),
                       widths=WIDTHS, head_bias=True, dropout=0.0,
                       **{k: (v if on else 0.0) for k, v in RATES.items()})


@pytest.fixture(scope='module')
def weights():
    w = ref.init_weights(3, V, WIDTHS, 'cpu')
    w['head_bias'] = 0.1 * torch.randn(V, generator=torch.Generator()
                                       .manual_seed(4))
    return w


@pytest.fixture(scope='module')
def batches():
    rng = np.random.default_rng(0)
    return [(rng.integers(1, V, (B, T)), rng.integers(1, V, (B, T)),
             np.ones((B, T), np.float32), i == 0) for i in range(3)]


def port_params(w, grad=False):
    """The reference's tree as the port's (no context tables)."""
    def t(a):
        return a.detach().clone().requires_grad_(grad)
    return {'char_embedding': t(w['char_embedding']),
            'context_embeddings': [],
            'lstm': [{k: t(v) for k, v in lw.items()} for lw in w['lstm']],
            'head_bias': t(w['head_bias'])}


def masks_of(cfg, state, n=1):
    return ref.trainer_masks(state, n, B, E, WIDTHS, cfg.weight_drop,
                             cfg.dropout_input, cfg.dropout_hidden,
                             cfg.dropout_output, 'cpu')


def port_forward(cfg, params, x, gen):
    return lm.forward_seq(params, cfg, torch.as_tensor(x), [],
                          lm.zero_carry(cfg, B, 'cpu'), train=True, rng=gen)


@pytest.mark.parametrize('on', [False, True], ids=['plain', 'dropouts'])
def test_logits_and_loss_match_the_reference(weights, batches, on):
    cfg = awd_cfg(on)
    x, y, mask, _ = batches[0]
    gen = torch.Generator().manual_seed(11)
    masks = masks_of(cfg, gen.get_state())[0]
    logits, (h, c) = port_forward(cfg, port_params(weights), x, gen)
    h0, c0 = ref.zeros(weights, B, 'cpu')
    want, hs, cs = ref.forward(weights, torch.as_tensor(x), h0, c0, masks)
    torch.testing.assert_close(logits, want, rtol=0, atol=LOGIT_ATOL)
    for a, b in zip(h + c, hs + cs):  # per-layer carries (B, W_l)
        torch.testing.assert_close(a, b, rtol=0, atol=LOGIT_ATOL)
    loss, _ = lm.sequence_xent(logits, torch.as_tensor(y),
                               torch.as_tensor(mask))
    want_loss = ref.xent(want, torch.as_tensor(y), torch.as_tensor(mask))
    assert abs(float(loss) - float(want_loss)) <= LOSS_RTOL * float(
        want_loss)


@pytest.mark.parametrize('on', [False, True], ids=['plain', 'dropouts'])
def test_every_gradient_matches_the_reference(weights, batches, on):
    cfg = awd_cfg(on)
    x, y, mask, _ = batches[0]
    gen = torch.Generator().manual_seed(12)
    masks = masks_of(cfg, gen.get_state())[0]
    params = port_params(weights, grad=True)
    logits, _ = port_forward(cfg, params, x, gen)
    loss = lm.sequence_xent(logits, torch.as_tensor(y),
                            torch.as_tensor(mask))[0] \
        + lm.regularization_loss(params)
    loss.backward()
    tree = {'char_embedding': weights['char_embedding'].clone(),
            'lstm': [{k: v.clone() for k, v in lw.items()}
                     for lw in weights['lstm']],
            'head_bias': weights['head_bias'].clone()}
    named = ref.leaves(tree)
    for _, p in named:
        p.requires_grad_(True)
    h0, c0 = ref.zeros(tree, B, 'cpu')
    want, _, _ = ref.forward(tree, torch.as_tensor(x), h0, c0, masks)
    (ref.xent(want, torch.as_tensor(y), torch.as_tensor(mask))
     + ref.regularization(tree)).backward()
    got = lm.param_leaves(params)
    assert len(got) == len(named)
    for (name, p), q in zip(named, got):
        scale = float(p.grad.abs().max())
        err = float((q.grad - p.grad).abs().max())
        assert err <= GRAD_OF_MAX * scale, (name, err, scale)


@pytest.mark.parametrize('on', [False, True], ids=['plain', 'dropouts'])
def test_three_adam_steps_match_the_reference(weights, batches, on):
    cfg = awd_cfg(on)
    params = port_params(weights, grad=True)
    opt = training.make_optimizer(params)
    gen = torch.Generator().manual_seed(13)
    masks = masks_of(cfg, gen.get_state(), 3)
    carry = None
    for x, y, mask, reset in batches:
        if reset:
            carry = lm.zero_carry(cfg, B, 'cpu')
        carry, _, _, _ = training.train_step(
            params, opt, cfg, torch.as_tensor(x), [], torch.as_tensor(y),
            torch.as_tensor(mask), carry, gen)
    want = ref.train_steps(weights, batches, masks, 'cpu')
    init = dict(ref.leaves(weights))
    for (name, _), p in zip(ref.leaves(weights), lm.param_leaves(params)):
        moved = p.detach() - init[name]
        moved_ref = want['weights'][name] - init[name]
        err = float((moved - moved_ref).abs().max())
        assert err <= UPDATE_ATOL, (name, err)


def test_uniform_widths_keep_the_models_bits():
    """Widths and head bias spelt out at their defaults
    (one width, no bias) run today's model: the same weights from the same
    seed, and logits, carry, loss, gradients and an Adam step equal bit
    for bit, the carry stacked (depth, B, W)."""
    base = lm.LMConfig(width=16, depth=2, voc_size=V)
    spelt = base.replace(widths=(16, 16))
    runs = []
    for cfg in (base, spelt):
        params = lm.init_params(cfg, torch.Generator().manual_seed(5))
        for t in lm.param_leaves(params):
            t.requires_grad_(True)
        opt = training.make_optimizer(params)
        rng = np.random.default_rng(1)
        x = torch.as_tensor(rng.integers(1, V, (B, T)))
        zs = [torch.as_tensor(rng.integers(0, 200, (B,)))]
        y = torch.as_tensor(rng.integers(1, V, (B, T)))
        mask = torch.ones((B, T))
        logits, carry = lm.forward_seq(params, cfg, x, zs, None)
        gen = torch.Generator().manual_seed(6)
        step = training.train_step(params, opt, cfg, x, zs, y, mask,
                                   lm.zero_carry(cfg, B, 'cpu'), gen)
        runs.append([logits.detach(), carry[0], carry[1], step[1]]
                    + [opt.state[p]['exp_avg'] for p in
                       lm.param_leaves(params)]
                    + [p.detach() for p in lm.param_leaves(params)])
    assert runs[0][1].shape == (2, B, 16)
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_h5_round_trip_of_unequal_widths(weights, tmp_path):
    """A checkpoint of the unequal-width model with a head bias loads back
    into an equal model: the config's keys and every weight (the
    dropout between layers, which AWD's places replace, at its default:
    the reference's schema keeps none)."""
    cfg = awd_cfg(True).replace(dropout=lm.LMConfig.dropout)
    params = port_params(weights)
    vocab = Vocab()
    vocab.assign(list('abcdefgh'))
    path = str(tmp_path / 'awd.h5')
    h5io.save_model(path, params, cfg, vocab, {'loss': [1.5]})
    loaded, cfg2, vocab2, history = h5io.load_model(path)
    assert cfg2 == cfg and history == {'loss': [1.5]}
    back = lm.params_from_numpy(loaded, 'cpu')
    assert len(lm.param_leaves(back)) == len(lm.param_leaves(params))
    for a, b in zip(lm.param_leaves(back), lm.param_leaves(params)):
        assert torch.equal(a, b)
    rater = Rater(device='cpu')
    rater.load_config(path)
    rater.configure()
    rater.load_weights(path)
    assert rater.cfg.layer_widths == WIDTHS and rater.cfg.head_bias
    assert torch.equal(rater.params['head_bias'], params['head_bias'])


def test_untied_widths_are_refused():
    with pytest.raises(ValueError, match='tied softmax'):
        lm.LMConfig(width=12, depth=3, widths=(24, 24, 16))
    with pytest.raises(ValueError, match='tied softmax'):
        lm.LMConfig(width=16, depth=2, widths=(16, 12))
    with pytest.raises(ValueError, match='one width for each'):
        lm.LMConfig(width=12, depth=3, widths=(24, 12))


def awd_rater(weights):
    rater = Rater(device='cpu')
    rater.width, rater.depth, rater.widths = E, 3, WIDTHS
    rater.head_bias, rater.contexts = True, ()
    rater.vocab.assign(list('abcdefgh'))
    rater.voc_size = rater.vocab.size
    rater.params = port_params(weights)
    rater.configure()
    rater.status = 2
    return rater


def test_kernels_of_one_width_refuse_unequal_widths(weights):
    """Decoding, the decode step, generation and the scoring kernel pack
    a (2D+1)W state: for this model they raise, naming its shape; scoring
    takes the layered path and works."""
    rater = awd_rater(weights)
    edges = [(0, 1, [('ab', 0.9), ('ba', 0.1)])]
    for call in (lambda: rater.rate_best_device(edges, 0, 1),
                 lambda: rater.rate_best_batch([edges]),
                 lambda: rater.predict(['a'], [None]),
                 lambda: rater.generate('ab', 4),
                 lambda: rater.generate_batch(['ab'], 4),
                 lambda: pack_score_weights(rater.params, rater.cfg)):
        with pytest.raises(ValueError, match=r'widths \(24, 24, 12\)'):
            call()
    probs = rater.rate('abcab')
    assert len(probs) == 5 and all(0 < p <= 1 for p in probs)


def test_evaluation_runs_the_layered_forward(weights, tmp_path):
    """``Rater.test`` scores the model through the same forward as
    training: its perplexity is exp of the reference's mean NLL."""
    rater = awd_rater(weights)
    text = 'abcabdeffedcba' * 3
    path = tmp_path / 'a_b_1800.txt'
    path.write_text(text, encoding='utf-8')
    ppl = rater.test([str(path)])
    ids = torch.as_tensor(np.array([rater.vocab.encode(text)]))
    h0, c0 = ref.zeros(weights, 1, 'cpu')
    logits, _, _ = ref.forward(weights, ids[:, :-1], h0, c0)
    nll = ref.xent(logits, ids[:, 1:], torch.ones_like(ids[:, 1:],
                                                       dtype=torch.float32))
    assert abs(ppl - float(torch.exp(nll))) <= 1e-5 * ppl


def test_cli_trains_and_saves_the_model(tmp_path):
    """``keraslm-rate train`` with AWD's options: a model of these widths,
    a head bias and no context, written and read back."""
    from click.testing import CliRunner
    from ocrd_keraslm_torch.scripts.run import cli
    rng = np.random.default_rng(2)
    words = ['die', 'der', 'und', 'vernunft', 'welt', 'zeit']
    files = []
    for name in ('goethe_faust_1808.txt', 'kant_kritik_1781.txt'):
        f = tmp_path / name
        f.write_text('\n'.join(' '.join(rng.choice(words, 8))
                               for _ in range(40)), encoding='utf-8')
        files.append(str(f))
    model = str(tmp_path / 'awd.h5')
    env = {'KERASLM_PLATFORM': 'cpu', 'KERASLM_CKPT_DIR': str(tmp_path)}
    res = CliRunner().invoke(cli, [
        'train', '-m', model, '-l', '16', '-b', '4', '-e', '1',
        '--widths', '24,24,12', '--head-bias', '--weight-drop', '0.2',
        '--dropout-input', '0.1', '--dropout-hidden', '0.1',
        '--dropout-output', '0.4', '--no-contexts'] + files, env=env)
    assert res.exit_code == 0, res.output
    cfg, _, _ = h5io.load_config(model)
    assert (cfg.layer_widths, cfg.width, cfg.head_bias, cfg.contexts,
            cfg.weight_drop, cfg.dropout_output) == (
                (24, 24, 12), 12, True, (), 0.2, 0.4)
    res = CliRunner().invoke(cli, ['train', '-m', str(tmp_path / 'x.h5'),
                                   '--widths', '24,,12'] + files,
                             env=env)
    assert res.exit_code != 0 and 'separated by commas' in res.output


CELL_RUN = """
import copy, json, sys, tempfile, torch
torch.set_num_threads(1)
from portbench import run
cell = run.Cell(run.Spec(), 'awd1840.train')
c, t = copy.deepcopy(cell.config), copy.deepcopy(cell.traffic)
c.update(widths=[24, 24, 12], batch=3, length=7)
t['corpus'].update(train_chars=3000, validation_chars=800)
cell.config, cell.traffic = c, t
res = run.execute(cell, 2 ** 31 + 12345, 0.5, False, device='cpu')
job = cell.kind.setup(cell, 5, tempfile.mkdtemp(), 'cpu')
cell.kind.window(job, 0.5, None)
cell.kind.release(job)
print(json.dumps([res['correct'], res['compared'], res['metrics'],
                  cell.kind.control(job, 5)]))
"""


def test_benchmark_cell_runs_on_the_cpu():
    """The benchmark cell's kind (``portbench/kinds/train_awd.py``) at a
    tiny size through ``portbench.run.execute`` on the CPU, in a process
    of its own (a run refuses a process that loaded JAX): its run is
    correct, and the bfloat16 control is not."""
    import json
    import subprocess
    import sys
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, '-c', CELL_RUN], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    correct, compared, metrics, control = json.loads(
        out.stdout.strip().splitlines()[-1])
    assert correct, compared
    assert metrics['train_chars_per_s']['value'] > 0
    assert any(n['value'] > n['limit'] for n in control), control


def test_benchmark_reference_is_this_reference():
    with open(os.path.join(REPO, 'tests', 'awd_lstm_reference.py'),
              encoding='utf-8') as fh:
        mine = fh.read()
    with open(os.path.join(REPO, 'portbench', 'reference', 'awd_lstm.py'),
              encoding='utf-8') as fh:
        assert fh.read() == mine


class _Event:
    """The fields of a profiler event that the weight drop's reader
    uses."""

    def __init__(self, name, cuda, start, dur, thread=1, corr=0, linked=0,
                 annotation=False):
        self._v = (name, cuda, start, dur, thread, corr, linked, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return 'DeviceType.CUDA' if self._v[1] else 'DeviceType.CPU'

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def start_thread_id(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]

    def linked_correlation_id(self):
        return self._v[6]

    def is_user_annotation(self):
        return self._v[7]


def _weight_drop_reader():
    import importlib.util
    path = os.path.join(REPO, 'portbench', 'metrics',
                        'train.weight_drop_ms_per_step.py')
    spec = importlib.util.spec_from_file_location('weight_drop_reader', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _traced_job(events, steps=2):
    from types import SimpleNamespace
    results = SimpleNamespace(events=lambda: events)
    tracer = SimpleNamespace(prof=SimpleNamespace(
        profiler=SimpleNamespace(kineto_results=results)))
    return SimpleNamespace(train_steps=steps, tracer=tracer,
                           trace=SimpleNamespace(t0=0, t1=10_000))


@pytest.mark.parametrize('case', ['linked', 'no_tracer', 'no_span',
                                  'no_linked_kernel'])
def test_weight_drop_reader_counts_the_spans_kernels(case):
    """``train.weight_drop_ms_per_step`` sums the device time of the
    kernels whose launching operation ran inside a weight drop span on
    the span's thread, clipped to the window: not the kernels of an
    operation after the span or on another thread, nor the device's
    mirror of a host range; it reads nothing without the profiler, the
    span or a linked kernel."""
    read = _weight_drop_reader().read
    span = _Event('keraslm.train.weight_drop', False, 100, 100, corr=1)
    ops = [_Event('aten::bernoulli_', False, 110, 30, corr=7),
           _Event('aten::mul', False, 150, 40, corr=8),
           _Event('aten::add', False, 250, 10, corr=9),
           _Event('aten::copy_', False, 120, 20, thread=2, corr=10)]
    kernels = [_Event('bernoulli', True, 1_000, 300, linked=7),
               _Event('mul', True, 9_900, 400, linked=8),
               _Event('add', True, 2_000, 5_000, linked=9),
               _Event('copy', True, 3_000, 7_000, linked=10),
               _Event('annotation', True, 1_000, 900, linked=7,
                      annotation=True)]
    if case == 'linked':
        # 300 ns and the 100 ns of the mul inside the window, over 2 steps
        assert read(_traced_job([span] + ops + kernels)) == 1e-6 * 400 / 2
    elif case == 'no_tracer':
        job = _traced_job([span] + ops + kernels)
        job.tracer = None
        assert read(job) is None
    elif case == 'no_span':
        assert read(_traced_job(ops + kernels)) is None
    else:
        assert read(_traced_job([span] + ops + kernels[2:])) is None
