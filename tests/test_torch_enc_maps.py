"""The device encoder's first two steps against the JAX package, on the CPU:
the level table, match_find (B5) against p1_reference and the Pallas
p1_call in interpret mode, and chain_walk (B6) against p15_reference, at
tolerance 0, on the shrunken geometry of tests/test_enc_lanes.py (8 KB
blocks, 2^10 tables) and at full geometry; the blocks that bound the
kernels' designs (tests/torch_cases.py::match_edge_blocks) at both."""

import dataclasses

import numpy as np
import pytest
import torch

import lizard_tpu.ops.enc_lanes as J
from lizard_tpu.utils.datagen import gen, text_like
import lizard_tpu_torch.ops.enc_lanes as P
from lizard_tpu_torch.utils import profiling
from tests.test_enc_lanes import CFG, FAR_CFG, _mk_blocks, _mk_far_blocks
from tests.torch_cases import chain_tail_maps, match_edge_blocks

PORT_FIELDS = [f.name for f in dataclasses.fields(P.EncCfg)]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The plain versions run thousands of small tensor operations; with
    intra-op threads, test workers running side by side starve each other,
    so this module runs torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_cfg(jcfg) -> P.EncCfg:
    """The port's EncCfg with the fields of a JAX EncCfg (tok_rows aside)."""
    return P.EncCfg(**{k: getattr(jcfg, k) for k in PORT_FIELDS})


def adversarial_blocks(seed):
    """The inputs of tests/test_enc_lanes.py::test_passA_cfg_sweep: runs,
    periodicity, a 4-symbol alphabet, block-tail edges."""
    rng = np.random.default_rng(seed)
    return [
        gen(CFG.n, 1, proba=0.8),
        text_like(CFG.n - 1, 2),
        bytes(np.tile(np.frombuffer(b"abcdefgh", np.uint8), CFG.n // 8)),
        (b"A" * 200 + bytes(rng.integers(0, 256, 57, np.uint8))) * 20,
        gen(CFG.n // 2 + 21, 3, proba=0.3),
        bytes(rng.integers(0, 4, CFG.n, np.uint8)),
        gen(127, 4, proba=0.7),
        b"\x00" * (CFG.n // 4),
    ]


# the combinations of tests/test_enc_lanes.py::test_passA_cfg_sweep
SWEEP = [
    dict(lazy=True, k5=0, maxoff=2047),
    dict(lazy=False, k5=1, maxoff=2047),
    dict(lazy=True, k5=2, maxoff=1023),
    dict(lazy=True, k5=4, maxoff=2047),
    dict(lazy=True, k5=2, chain=2, maxoff=2047),
    dict(lazy=True, k5=0, chain=3, pref=16, maxoff=2047),
]


def sweep_case(combo):
    """(JAX cfg, blocks) of one sweep combination, seeded as there."""
    jcfg = dataclasses.replace(CFG, **combo)
    return jcfg, adversarial_blocks(combo["k5"] * 7 + combo["maxoff"])


def port_maps(blocks, jcfg):
    cfg = port_cfg(jcfg)
    data, lens = P.pack_blocks(blocks, cfg)
    return cfg, data, lens, P.match_find(data, lens, cfg)


@pytest.mark.parametrize("level", range(10, 50))
def test_cfg_for_level_equals_reference(level):
    j, t = J.cfg_for_level(level), P.cfg_for_level(level)
    for k in PORT_FIELDS:
        assert getattr(t, k) == getattr(j, k), k
    assert (t.nmaps, t.ncand) == (j.nmaps, j.ncand)


@pytest.mark.parametrize("name,jcfg,blocks", [
    ("base", CFG, _mk_blocks(0)),
    ("base seed 7", CFG, _mk_blocks(7)),
    ("k5=1", dataclasses.replace(CFG, k5=1, lazy=1), _mk_blocks(71)),
    ("k5=2", dataclasses.replace(CFG, k5=2, lazy=1), _mk_blocks(91)),
    ("k5=4", dataclasses.replace(CFG, k5=4, lazy=2), _mk_blocks(4)),
    ("far", FAR_CFG, _mk_far_blocks(5)),
    ("far k5=4", dataclasses.replace(FAR_CFG, k5=4, lazy=2),
     _mk_far_blocks(6)),
    ("chain=2", dataclasses.replace(CFG, chain=2, lazy=1), _mk_blocks(19)),
])
def test_match_find_equals_p1_reference(name, jcfg, blocks):
    ref, _ = J.p1_reference(blocks, jcfg)
    cfg, _, _, maps = port_maps(blocks, jcfg)
    assert maps.dtype == torch.uint16
    assert tuple(maps.shape) == (8, cfg.nmaps, cfg.n)
    assert torch.equal(maps, P.maps_from_reference(ref, cfg))
    if jcfg.far:
        assert maps[:, cfg.nmaps - 1].to(torch.int32).any()   # far candidates


@pytest.mark.parametrize("combo", SWEEP, ids=str)
def test_match_find_adversarial_equals_p1_reference(combo):
    jcfg, blocks = sweep_case(combo)
    ref, _ = J.p1_reference(blocks, jcfg)
    cfg, _, _, maps = port_maps(blocks, jcfg)
    assert torch.equal(maps, P.maps_from_reference(ref, cfg))


def test_match_find_equals_pallas_kernel():
    """Against the TPU kernel itself, in interpret mode."""
    import jax.numpy as jnp
    jcfg = dataclasses.replace(CFG, k5=2, lazy=1)
    blocks = _mk_blocks(3)
    w32i, meta = J.pack_blocks(blocks, jcfg)
    packed = J.p1_call(jnp.asarray(w32i), jnp.asarray(meta), jcfg,
                       interpret=True)
    want = np.stack([J.unpack_d16(packed, jcfg, m)
                     for m in range(jcfg.nmaps)], 1)
    _, _, _, maps = port_maps(blocks, jcfg)
    assert torch.equal(maps, P.maps_from_reference(want))


@pytest.mark.parametrize("chain,pref", [(2, 8), (3, 8), (2, 16), (3, 16)])
def test_chain_walk_equals_p15_reference(chain, pref):
    jcfg = dataclasses.replace(CFG, chain=chain, pref=pref, lazy=1)
    blocks = _mk_blocks(19 + chain)
    blocks[5] = adversarial_blocks(1)[5]               # dense 4-symbol block
    ref, _ = J.p1_reference(blocks, jcfg)
    cfg = port_cfg(jcfg)
    data, lens = P.pack_blocks(blocks, cfg)
    maps = P.maps_from_reference(ref, cfg)
    won = P.chain_walk(data, lens, maps, cfg)
    want = P.maps_from_reference(J.p15_reference(blocks, jcfg, dmap=ref))
    assert tuple(won.shape) == (8, cfg.ncand, cfg.n)
    assert torch.equal(won, want)
    assert not torch.equal(won[:, 0], maps[:, 0])       # the walk moved
    assert torch.equal(maps, P.maps_from_reference(ref, cfg))   # not in place


def test_chain_walk_passes_k5_maps_through():
    jcfg = dataclasses.replace(CFG, k5=2, chain=2, lazy=1)
    blocks = adversarial_blocks(9)
    ref, _ = J.p1_reference(blocks, jcfg)
    cfg, data, lens, maps = port_maps(blocks, jcfg)
    won = P.chain_walk(data, lens, maps, cfg)
    assert torch.equal(won, P.maps_from_reference(
        J.p15_reference(blocks, jcfg, dmap=ref)))


@pytest.mark.parametrize("level", [10, 21])
def test_full_geometry(level):
    """cfg_for_level at full size (128 KB blocks, 2^13 tables, the 64 KB
    far table at 21): maps and tokens equal the mirrors'."""
    jcfg = J.cfg_for_level(level)
    a = gen(70_000, level, proba=0.5)
    blocks = [gen(131072, level, proba=0.7), (a + a)[:131072]]
    ref, _ = J.p1_reference(blocks, jcfg)
    cfg, data, lens, maps = port_maps(blocks, jcfg)
    assert torch.equal(maps, P.maps_from_reference(ref, cfg)[:2])
    toks = P.token_arrays(*P.parse_tokens(data, lens, maps, cfg))
    want = J.p2_reference(blocks, jcfg, dmap=ref)
    for b in range(2):
        assert list(zip(*(t.tolist() for t in toks[b]))) == want[b], b
    if cfg.far:
        assert (toks[1][2] >= 65536).any()             # off24 tokens


def edge_against_mirrors(jcfg, blocks):
    """match_find (and at chain tiers chain_walk, on its maps and on
    chain_tail_maps of them) on `blocks` against p1_reference and
    p15_reference, 8 blocks a call (the mirrors' batch). Returns the maps
    and the walked maps."""
    cfg = port_cfg(jcfg)
    got, walked = [], []
    for at in range(0, len(blocks), 8):
        part = blocks[at:at + 8]
        ref, _ = J.p1_reference(part, jcfg)
        data, lens = P.pack_blocks(part, cfg)
        maps = P.match_find(data, lens, cfg)
        assert torch.equal(maps, P.maps_from_reference(ref, cfg)[:len(part)])
        got.append(maps)
        if not cfg.chain:
            continue
        for m in (maps, chain_tail_maps(maps)):
            dmap = np.zeros((8, cfg.nmaps, cfg.n), np.int64)
            dmap[:len(part)] = m.numpy()
            won = P.chain_walk(data, lens, m, cfg)
            want = P.maps_from_reference(
                J.p15_reference(part, jcfg, dmap=dmap))[:len(part)]
            assert torch.equal(won, want)
            walked.append(won)
    return torch.cat(got), walked


@pytest.mark.parametrize("name,jcfg", [
    ("base", CFG),
    ("k5=1", dataclasses.replace(CFG, k5=1, lazy=1)),
    ("k5=4", dataclasses.replace(CFG, k5=4, lazy=2)),
    ("far", FAR_CFG),
    ("far k5=4", dataclasses.replace(FAR_CFG, k5=4, lazy=2)),
    ("chain 16", dataclasses.replace(CFG, chain=16, lazy=2)),
    ("chain 64 pref 16", dataclasses.replace(CFG, chain=64, pref=16, lazy=2,
                                             maxoff=65535)),
])
def test_match_edge_blocks_equal_mirrors(name, jcfg):
    """The blocks that bound the kernels' designs, at the small geometry:
    maps and walks equal the mirrors'; the cases take what they are for."""
    blocks = match_edge_blocks(jcfg.n, jcfg.far_dist)
    maps, walked = edge_against_mirrors(jcfg, blocks)
    cfg = port_cfg(jcfg)
    m0 = maps[:, 0].to(torch.int32)
    assert (m0[0] > 0).sum() == cfg.n - 20 - cfg.min_offset   # the run
    # two kept lanes in segment 1: segment 2 finds segment 0's word
    assert m0[1, 276] == 276 - 10 and m0[1, 178] == 178 - 10
    assert not m0[2:5].any() and m0[5, :1000 - 20].any()   # len 20-22, 1000
    if cfg.far:
        far = maps[7, cfg.nmaps - 1].to(torch.int32)
        assert far.any() and int(far.max()) <= cfg.far_dist - 1
    if cfg.chain:
        assert not torch.equal(walked[0][:, 0], maps[:8, 0])  # the walk moved


def test_match_edge_blocks_full_geometry():
    """The edge blocks at level 49's geometry (2^16 table, 64-step chains,
    pref 16): maps and walks equal the mirrors'."""
    jcfg = J.cfg_for_level(49)
    blocks = match_edge_blocks(jcfg.n, jcfg.far_dist)
    maps, _ = edge_against_mirrors(jcfg, blocks[:1] + blocks[8:11])
    assert maps[:, 1].any()                              # delta maps


def test_maps_from_reference():
    one = np.zeros((2, CFG.n), np.int64)
    one[1, 5] = 65535
    t = P.maps_from_reference(one, port_cfg(CFG))
    assert t.dtype == torch.uint16 and tuple(t.shape) == (2, 1, CFG.n)
    assert int(t[1, 0, 5]) == 65535
    with pytest.raises(ValueError):
        P.maps_from_reference(one + 70000)
    with pytest.raises(ValueError):
        P.maps_from_reference(one[:, :100], port_cfg(CFG))


def test_wrappers_check_inputs():
    cfg = port_cfg(CFG)
    data, lens = P.pack_blocks([b"abc" * 100], cfg)
    with pytest.raises(ValueError, match="data"):
        P.match_find(data[:, :-1].contiguous(), lens, cfg)
    with pytest.raises(ValueError, match="lens"):
        P.match_find(data, lens.to(torch.int64), cfg)
    maps = P.match_find(data, lens, cfg)
    with pytest.raises(ValueError, match="maps"):
        P.parse_tokens(data, lens, maps.to(torch.int32), cfg)
    with pytest.raises(ValueError, match="chain"):
        P.chain_walk(data, lens, maps, cfg)
    with pytest.raises(ValueError, match="cfg.n"):
        P.pack_blocks([bytes(cfg.n + 1)], cfg)


def test_profiles_run_on_the_card_only():
    """The profiling instances have no plain version: CPU tensors raise."""
    cfg = port_cfg(dataclasses.replace(CFG, chain=2, lazy=1))
    data, lens = P.pack_blocks(_mk_blocks(2)[:2], cfg)
    maps = P.match_find(data, lens, cfg)
    with pytest.raises(ValueError, match="cuda"):
        P.match_find_profile(data, lens, cfg)
    with pytest.raises(ValueError, match="cuda"):
        P.chain_walk_profile(data, lens, maps, cfg)


def test_cpu_tensors_take_the_plain_versions():
    """On CPU tensors the wrappers run their plain versions and launch
    nothing; the results equal the plain versions'."""
    cfg = port_cfg(dataclasses.replace(CFG, chain=2, lazy=1))
    data, lens = P.pack_blocks(_mk_blocks(2)[:3], cfg)
    names = ("match_find.launches", "chain_walk.launches",
             "parse_tokens.launches")
    before = [profiling.counters()[n] for n in names]
    maps = P.match_find(data, lens, cfg)
    assert torch.equal(maps, P.match_find_plain(data, lens, cfg))
    won = P.chain_walk(data, lens, maps, cfg)
    assert torch.equal(won, P.chain_walk_plain(data, lens, maps, cfg))
    pcfg = dataclasses.replace(cfg, chain=0)
    tok, cnt = P.parse_tokens(data, lens, won, pcfg)
    ptok, pcnt = P.parse_tokens_plain(data, lens, won, pcfg)
    assert torch.equal(cnt, pcnt) and torch.equal(tok, ptok)
    assert [profiling.counters()[n] for n in names] == before
