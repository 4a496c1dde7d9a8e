"""The seeded inputs: the same seed gives the same inputs, and every seed
gives the same sizes."""
import filecmp
import os

import numpy as np

from portbench import inputs

CHARSET = sorted(set(''.join(inputs.GERMAN_WORDS)) | {' ', '\n', ','})


def _workspace(path, seed):
    return inputs.build_workspace(str(path), np.random.default_rng(seed), 2,
                                  5, CHARSET, identifier='urn:t/doc_1784')


def test_workspace_is_deterministic(tmp_path):
    a = _workspace(tmp_path / 'a', 11)
    b = _workspace(tmp_path / 'b', 11)
    assert a == b
    cmp = filecmp.dircmp(tmp_path / 'a', tmp_path / 'b')
    assert not cmp.diff_files and not cmp.left_only and not cmp.right_only
    sub = cmp.subdirs['OCR-D-OCR']
    assert not sub.diff_files and len(sub.same_files) == 2


def test_workspace_sizes_do_not_depend_on_the_seed(tmp_path):
    words, alts = set(), set()
    for seed in (1, 2, 3):
        pages = _workspace(tmp_path / str(seed), seed)
        words.add(tuple(sum(1 for g, a in p if g is None) for p in pages))
        alts.add(tuple(sum(1 for g, a in p if len(a) > 1) /
                       sum(1 for g, a in p if g is not None)
                       for p in pages))
    assert len(words) == 1
    assert all(abs(a - 0.15) < 0.01 for al in alts for a in al)


def test_written_glyphs_match_the_lattice(tmp_path):
    pages = _workspace(tmp_path / 'w', 5)
    glyphs = inputs.read_glyphs(os.path.join(
        tmp_path / 'w', 'OCR-D-OCR', 'OCR-D-OCR_phys_0001.xml'))
    lattice = {g: list(a) for g, a in pages[0] if g is not None}
    assert glyphs == lattice
    for alts in lattice.values():
        assert len({c for c, _ in alts}) == len(alts)


def test_corpus_and_prompts_are_deterministic(tmp_path):
    a = inputs.write_corpus(str(tmp_path / 'a'), np.random.default_rng(3),
                            {'x_y_1800.txt': 500})
    b = inputs.write_corpus(str(tmp_path / 'b'), np.random.default_rng(3),
                            {'x_y_1800.txt': 500})
    assert open(a[0]).read() == open(b[0]).read()
    assert len(open(a[0]).read()) == 500
    for n in (3, 6, 12, 36):
        p = inputs.prompt(np.random.default_rng(n), CHARSET, n)
        assert p == inputs.prompt(np.random.default_rng(n), CHARSET, n)
        assert len(p) == n and p.endswith(' ')
        assert set(p.split()) <= set(inputs.GERMAN_WORDS)
