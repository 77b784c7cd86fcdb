"""The host side of the wgmma core's weight ring (dfanerf_torch/ops/_build.py
ring_blob, csrc/field_wgmma.cuh): the staged blob of every kernel library
(render_rays, pair_field, render_head, pair_perz, sigma_head, pair_hier,
far_eval, node_grid) against the ``weight_blobs`` blob it is re-laid from, on packed
weights of a seeded decoder. Nothing is compiled here: the tests read the
staged blob as the kernel's wgmma descriptors address it (start address,
leading byte offset 128 B along K, stride byte offset KS/8 x 128 B along N)
and walk its slabs in the order the kernel's layers consume them, the far
kernels' 128-ray chunks included; and each source's ``<name>_layout`` is
read to check that its library gets the staged blob."""

import re

import pytest
import torch

from dfanerf_torch.models import Decoder, DecoderConfig
from dfanerf_torch.models.layers import init_uniform_
from dfanerf_torch.ops import _build
from dfanerf_torch.ops.far_eval import _far_rows, far_head_reference, far_torso_reference
from dfanerf_torch.ops.fused_render import _deform, _field_rows, _mm_kernel, density_act, sigma_only
from dfanerf_torch.ops.pack import pack_field_weights
from dfanerf_torch.ops.sigma_head import sigma_rows

HEADER = (_build.CSRC / "field_wgmma.cuh").read_text()
ROWS = 64


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", HEADER).group(1))


@pytest.fixture(scope="module")
def packed():
    g = torch.Generator().manual_seed(1)
    dec = init_uniform_(Decoder(DecoderConfig()), g)
    vecs = [torch.randn(n, generator=g) for n in (96, 42, 256, 256)]
    return {"head": pack_field_weights(dec, vecs[0], vecs[2], vecs[3], "head"),
            "torso": pack_field_weights(dec, vecs[1], vecs[2], vecs[3], "torso")}


def _k16_tile(slab, n, kk):
    """The [n][16] B tile of k16 step kk of a staged slab, read as the
    kernel's descriptor addresses it (offsets in bf16 elements: 8 per 16 B)."""
    ks = _build.SLAB // n
    start, lbo, sbo = kk * 128, 64, ks // 8 * 64
    rows = torch.arange(n)[:, None]
    cols = torch.arange(16)[None, :]
    idx = start + (rows // 8) * sbo + (cols // 8) * lbo + (rows % 8) * 8 + cols % 8
    return slab[idx]


def _unstage(staged, pos, n, k):
    """The [n][k] matrix whose k / KS slabs start at slab ``pos``."""
    ks = _build.SLAB // n
    tiles = []
    for s in range(k // ks):
        slab = staged[(pos + s) * _build.SLAB:(pos + s + 1) * _build.SLAB]
        tiles += [_k16_tile(slab, n, kk) for kk in range(ks // 16)]
    return torch.cat(tiles, dim=1)


def test_staged_sizes_match_the_kernel(packed):
    assert _build.SLAB == _const("SLAB") == 8192
    for branch, ns in (("head", _const("NS_HEAD")), ("torso", _const("NS_TORSO"))):
        w, _ = _build.weight_blobs(packed[branch], branch)
        staged = _build.ring_blob(w, branch)
        assert staged.dtype == torch.bfloat16 and staged.is_contiguous()
        assert staged.numel() == ns * _build.SLAB + 2 * 8 * 256
        assert sum(n * k for _, n, k in _build.ring_layers(branch)) == ns * _build.SLAB
    assert (_const("NS_HEAD"), _const("NS_DEFORM"), _const("NS_TORSO")) == (68, 12, 84)


@pytest.mark.parametrize("branch", ["head", "torso"])
def test_slabs_hold_the_blob_matrices(packed, branch):
    """Every ring slab, read through the descriptors, is the k-slab of the
    [out][in] matrix it stands for, bit for bit; the narrow rows follow."""
    w, _ = _build.weight_blobs(packed[branch], branch)
    staged = _build.ring_blob(w, branch)
    pos = 0
    for off, n, k in _build.ring_layers(branch):
        assert torch.equal(_unstage(staged, pos, n, k), w[off:off + n * k].reshape(n, k))
        pos += n * k // _build.SLAB
    pw = packed[branch]
    narrow = staged[pos * _build.SLAB:].reshape(2, 8, 256)
    assert torch.equal(narrow[0], pw["w_sf"][:, :8].t())
    assert torch.equal(narrow[1], pw["w_out"][:, :8].t())


@pytest.mark.parametrize("branch", ["head", "torso"])
def test_ring_walk_reproduces_each_product(packed, branch):
    """Summing the k16 steps of each layer's slabs, as the kernel's wgmma
    chain does, gives the product with the [out][in] matrix of the blob."""
    w, _ = _build.weight_blobs(packed[branch], branch)
    staged = _build.ring_blob(w, branch)
    g = torch.Generator().manual_seed(2)
    pos = 0
    for off, n, k in _build.ring_layers(branch):
        a = torch.randn(ROWS, k, generator=g).to(torch.bfloat16).float()
        ks = _build.SLAB // n
        acc = torch.zeros(ROWS, n)
        for s in range(k // ks):
            slab = staged[(pos + s) * _build.SLAB:(pos + s + 1) * _build.SLAB]
            for kk in range(ks // 16):
                k0 = s * ks + kk * 16
                acc += a[:, k0:k0 + 16] @ _k16_tile(slab, n, kk).float().t()
        want = a @ w[off:off + n * k].reshape(n, k).float().t()
        torch.testing.assert_close(acc, want, rtol=1e-5, atol=1e-4)
        pos += k // ks


B_IN, B_BLK, B_SKIP, B_SF, B_OUT = 0, 256, 256 + 7 * 256, 256 + 8 * 256, 256 + 8 * 256 + 384


def _mm(a, wt):
    return a.to(torch.bfloat16).float() @ wt


class _Cursor:
    """Takes each wide layer's weight from the staged blob in turn, as the
    kernel's ring hands the slabs to its layers; ``pos`` counts the slabs
    taken."""

    def __init__(self, staged):
        self.staged, self.pos = staged, 0

    def take(self, n, k):
        m = _unstage(self.staged, self.pos, n, k)
        self.pos += n * k // _build.SLAB
        return m.float().t().contiguous()

    def relu_layer(self, a, n, k, bias):
        return (_mm(a, self.take(n, k)) + bias).relu().to(torch.bfloat16).float()


def _walk_trunk(cur, b, x):
    """The trunk over its input x (float, bf16 values) in field_wgmma.cuh
    wg_trunk's order: the input layer, blocks 0-3, the skip, blocks 4-6."""
    k_in = x.shape[1]
    h = cur.relu_layer(x, 256, k_in, b[B_IN:B_IN + 256])
    for i in range(7):
        bias = b[B_BLK + i * 256:B_BLK + (i + 1) * 256]
        if i == 3:
            h = (_mm(h, cur.take(256, 256)) + bias).relu()
            h = (h + _mm(x, cur.take(256, k_in)) + b[B_SKIP:B_SKIP + 256]).to(
                torch.bfloat16).float()
        else:
            h = cur.relu_layer(h, 256, 256, bias)
    return h


def _walk_deform(cur, b, pe):
    """The torso's deformation net over its PE rows pe (float, bf16 values)
    in field_wgmma.cuh wg_deform's order: the trunk's input, bf16 values."""
    db1, dbk = B_OUT + 8, B_OUT + 8 + 128
    dbskip, dbout, sig_pad = dbk + 4 * 128, dbk + 5 * 128, dbk + 6 * 128
    h = cur.relu_layer(pe, 128, 64, b[db1:db1 + 128])
    h = cur.relu_layer(h, 128, 128, b[dbk:dbk + 128])
    h = cur.relu_layer(h, 128, 128, b[dbk + 128:dbk + 256])
    h = (_mm(h, cur.take(128, 128)) + b[dbk + 256:dbk + 384]).relu()
    h = (h + _mm(pe, cur.take(128, 64)) + b[dbskip:dbskip + 128]).to(torch.bfloat16).float()
    h = cur.relu_layer(h, 128, 128, b[dbk + 384:dbk + 512])
    d = _mm(h, cur.take(128, 128)) + b[dbout:dbout + 128] + b[sig_pad:sig_pad + 128]
    return (d + torch.cat([pe, torch.zeros_like(pe)], dim=1)).to(torch.bfloat16).float()


def _walk_field(staged, b, x, vr, branch, act):
    """The field over rows x [ROWS, 64] bf16 with every wide layer's weight
    taken from the staged blob by a cursor, in the order the kernel's code
    runs its layers (field_wgmma.cuh wg_deform, wg_trunk, wg_trunk_and_heads)."""
    cur = _Cursor(staged)
    x = _walk_deform(cur, b, x.float()) if branch == "torso" else x.float()
    h = _walk_trunk(cur, b, x)
    narrow = staged[-2 * 8 * 256:].reshape(2, 8, 256).float()
    sigma = _mm(h, narrow[0, 0:1].t())[:, 0] + b[B_SF]
    feat = ((_mm(h, cur.take(256, 256)) + b[B_SF + 128:B_SF + 384]) + vr).relu()
    rgb = torch.sigmoid(_mm(feat, narrow[1, 0:3].t()) + b[B_OUT:B_OUT + 3])
    return density_act(sigma, act), rgb, cur.pos


@pytest.mark.parametrize("branch", ["head", "torso"])
def test_ring_walk_runs_the_field(packed, branch):
    """A plain walk of the staged blob in the kernel's layer order computes
    the field of the plain version (_field_rows) and consumes every slab."""
    pw = packed[branch]
    w, b = _build.weight_blobs(pw, branch)
    staged = _build.ring_blob(w, branch)
    g = torch.Generator().manual_seed(3)
    x = torch.sin(torch.randn(ROWS, 64, generator=g) * 3.0)
    x[:, 60:] = 0.0
    x = x.to(torch.bfloat16)
    vr = torch.randn(ROWS, 256, generator=g) * 0.1
    sigma, rgb, used = _walk_field(staged, b, x, vr, branch, "softplus")
    want_sigma, want_rgb = _field_rows(pw, x, vr, branch, "softplus")
    assert used == _const("NS_HEAD" if branch == "head" else "NS_TORSO")
    torch.testing.assert_close(sigma, want_sigma, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(rgb, want_rgb, rtol=1e-4, atol=1e-5)


def _walk_sigma(staged, b, x, act, branch="head"):
    """A field's density over rows x in a density-only chunk's order (the
    torso's deformation net, the trunk, then the sigma rows at the staged
    blob's end); the slabs taken."""
    cur = _Cursor(staged)
    x = _walk_deform(cur, b, x.float()) if branch == "torso" else x.float()
    h = _walk_trunk(cur, b, x)
    sigw = _const("NS_HEAD" if branch == "head" else "NS_TORSO") * _build.SLAB  # Staged::SIGW
    sig_rows = staged[sigw:sigw + 8 * 256].reshape(8, 256).float()
    return density_act(_mm(h, sig_rows[0:1].t())[:, 0] + b[B_SF], act), cur.pos


@pytest.mark.parametrize("act", ["relu", "softplus"])
def test_ring_walk_runs_the_sigma_trunk(packed, act):
    """The density-only walk (field_wgmma.cuh wg_sigma_walk, sigma_head and
    pair_sigma): the trunk from the head's staged blob in wg_trunk's order,
    then the sigma rows at the blob's end, computes the plain version's
    density (sigma_rows) and consumes exactly the first NS_HEAD_TRUNK slabs;
    that is the density-only chunk's L2 traffic."""
    pw = packed["head"]
    w, b = _build.weight_blobs(pw, "head")
    staged = _build.ring_blob(w, "head")
    g = torch.Generator().manual_seed(4)
    x = torch.sin(torch.randn(ROWS, 64, generator=g) * 3.0)
    x[:, 60:] = 0.0
    x = x.to(torch.bfloat16)
    sigma, used = _walk_sigma(staged, b, x, act)
    assert used == _const("NS_HEAD_TRUNK") == _const("NS_HEAD") - 256 * 256 // _build.SLAB
    torch.testing.assert_close(sigma, sigma_rows(sigma_only(pw), x, act), rtol=1e-4, atol=1e-5)
    assert _build.staged_weight_bytes("head", color=False) == 2 * (
        used * _build.SLAB + 8 * 256) == 987_136


@pytest.mark.parametrize("name", ["sigma_head", "pair_hier"])
def test_density_kernels_share_the_sigma_walk(name):
    """sigma_head.cu and pair_hier.cu run the one density-only walk of the
    wgmma core, and their producers stream NS_HEAD_TRUNK slabs a chunk for
    its 16 chunks, so pair_sigma with every pair listed is sigma_head bit for
    bit and neither copies the view feature's slabs."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    assert '#include "field_wgmma.cuh"' in src and "field_mlp.cuh" not in src
    assert len(re.findall(r"\bwg_sigma_walk\(", src)) == 1
    assert re.findall(r"ring\.produce\([^;]*\);", src) == [
        "ring.produce(p.w, NS_HEAD_TRUNK, 2 * SS);"]
    assert "wg_trunk_and_heads" not in src and "NS_HEAD)" not in src
    assert len(re.findall(r"void wg_sigma_walk\(", HEADER)) == 1


@pytest.mark.parametrize("act", ["relu", "softplus"])
@pytest.mark.parametrize("branch", ["head", "torso"])
def test_node_grid_walk_runs_the_density_only_field(packed, branch, act):
    """node_grid.cu's chunk: the torso's deformation net, the trunk, then the
    sigma rows at the staged blob's end, computes the kernel's semantics
    (occupancy.node_grid_rows: the deformation on the bf16 PE, sigma_rows)
    and consumes exactly the slabs its producer issues a chunk: the first
    NS_HEAD_TRUNK or NS_TORSO_TRUNK, never the view feature's."""
    src = (_build.CSRC / "node_grid.cu").read_text()
    assert re.findall(r"ring\.produce\([^;]*\);", src) == [
        "ring.produce(p.w, TORSO ? NS_TORSO_TRUNK : NS_HEAD_TRUNK, mine);"]
    assert "constexpr int NS_TORSO_TRUNK = NS_TORSO - slabs(HID, HID);" in src
    ns = {"head": _const("NS_HEAD_TRUNK"), "torso": _const("NS_TORSO") - 256 * 256 // _build.SLAB}
    pw = packed[branch]
    w, b = _build.weight_blobs(pw, branch)
    staged = _build.ring_blob(w, branch)
    g = torch.Generator().manual_seed(6)
    x = torch.sin(torch.randn(ROWS, 64, generator=g) * 3.0)
    x[:, 60:] = 0.0
    x = x.to(torch.bfloat16)
    sigma, used = _walk_sigma(staged, b, x, act, branch)
    assert used == ns[branch] == {"head": 60, "torso": 76}[branch]
    inp = _deform(pw, x, _mm_kernel) if branch == "torso" else x
    torch.testing.assert_close(sigma, sigma_rows(sigma_only(pw), inp, act), rtol=1e-4, atol=1e-5)
    assert _build.staged_weight_bytes(branch, color=False) == 2 * (used * _build.SLAB + 8 * 256)


@pytest.mark.parametrize("layout", ["staged", "plain", "neither"])
def test_binding_hands_each_library_the_layout_it_reports(packed, layout):
    """Binding.blobs gives a library the staged weight blob, the one layout
    of the wgmma core, which every library runs: a library reporting any
    other size, the plain blob's (the deleted mma.sync core's) included,
    is refused."""
    binding = _build.Binding("render_rays", {})
    plain = {br: _build.weight_blobs(packed[br], br) for br in ("head", "torso")}
    staged = {br: _build.ring_blob(plain[br][0], br) for br in ("head", "torso")}
    w_sizes = {"staged": {br: staged[br].numel() for br in staged},
               "plain": {br: plain[br][0].numel() for br in plain},
               "neither": {br: plain[br][0].numel() + 8 for br in plain}}[layout]
    binding._lib = object()  # stands in for the loaded library
    binding._layout = (w_sizes["head"], plain["head"][1].numel(), w_sizes["torso"],
                       plain["torso"][1].numel(), 0)
    for br in ("head", "torso"):
        if layout != "staged":
            with pytest.raises(ValueError, match="kernel expects"):
                binding.blobs(packed[br], br, torch.device("cpu"))
            continue
        w, b = binding.blobs(packed[br], br, torch.device("cpu"))
        assert torch.equal(w, staged[br])
        assert torch.equal(b, plain[br][1])


# The libraries of the wgmma core: every one.
WGMMA = ("render_rays", "pair_field", "render_head", "pair_perz", "sigma_head", "pair_hier",
         "far_eval", "node_grid")


def _layout_exprs(name):
    """{slot: C++ expression} of the sizes a source's <name>_layout writes."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    body = re.search(rf"int {name}_layout\(int\* sizes\) {{(.*?)\n}}", src, re.S)
    assert body, f"{name}.cu defines no {name}_layout"
    return {int(i): e.strip() for i, e in re.findall(r"sizes\[(\d)\] = ([^;]+);", body.group(1))}


@pytest.mark.parametrize("name", _build.SOURCES)
def test_each_library_reports_the_blobs_of_its_core(packed, name):
    """A source's <name>_layout reports the staged weight size (the ring's
    slabs and the narrow rows), every source running the wgmma core, so
    Binding.blobs hands its library the blob its kernels read; the bias
    sizes are the plain bias blobs'."""
    assert name in WGMMA
    plain = {br: _build.weight_blobs(packed[br], br) for br in ("head", "torso")}
    value = {"Staged<PEW>::END": _const("NS_HEAD") * _const("SLAB") + 2 * 8 * 256,
             "Staged<DEF>::END": _const("NS_TORSO") * _const("SLAB") + 2 * 8 * 256,
             "B_END": plain["head"][1].numel(), "TORSO_BEND": plain["torso"][1].numel(), "0": 0}
    exprs = _layout_exprs(name)
    assert sorted(exprs) == list(range(_build.LAYOUT_SIZES))
    assert set(exprs[i] for i in range(4)) <= set(value), exprs
    sizes = [value[exprs[i]] for i in range(4)]
    branches = ("head", "torso") if sizes[2] else ("head",)
    assert sizes[2:] == [0, 0] or branches == ("head", "torso")
    binding = _build.Binding(name, {})
    binding._lib = object()  # stands in for the loaded library
    binding._layout = (*sizes, 0)
    for i, br in enumerate(branches):
        w_plain, b_plain = plain[br]
        staged = _build.staged_weight_bytes(br) // 2
        assert sizes[2 * i] == staged, (name, br)
        assert sizes[2 * i + 1] == b_plain.numel()
        w, b = binding.blobs(packed[br], br, torch.device("cpu"))
        assert torch.equal(w, _build.ring_blob(w_plain, br))
        assert torch.equal(b, b_plain)


# far_eval.cu: 128-ray chunks; the ragged last chunk's rows at or past n
# read ray n - 1 (CLAMP) and are not stored.
FAR = 0.9


def _far_inputs(n):
    g = torch.Generator().manual_seed(5)
    o, d = torch.randn(n, 3, generator=g) * 0.05, torch.randn(n, 3, generator=g) * 0.2
    d[:, 2] -= 1.0
    return o, d, (torch.randn(n, 256, generator=g) * 0.1).to(torch.bfloat16)


def _far_chunk(staged, b, branch, o, d, vr, ray0, act):
    """One chunk of far_eval.cu's far_head_chunk or far_torso_chunk: the
    chunk's 128 rows (clamped rays), each wide layer's weight taken from the
    field's staged blob from its start (the producer's ring.produce(w, ns,
    1)). Returns the values of the rows below n and the slabs taken."""
    n = o.shape[0]
    rays = (ray0 + torch.arange(128)).clamp(max=n - 1)
    x = _far_rows(o, d, FAR, rays)
    if branch == "head":
        sigma, used = _walk_sigma(staged, b, x, act)
        out = sigma[:, None]
    else:
        _, out, used = _walk_field(staged, b, x, vr[rays].float(), "torso", act)
    return out[:n - ray0], used


def _far_walk(packed, branches, o, d, vr, act):
    """far_eval.cu's kernel over n rays: per chunk, the walk of each field in
    ``branches`` in turn. Returns each field's output and the (field, slabs)
    sequence its producer must issue."""
    blobs = {}
    for br in branches:
        w, b = _build.weight_blobs(packed[br], br)
        blobs[br] = (_build.ring_blob(w, br), b)
    outs, seq = {br: [] for br in branches}, []
    for ray0 in range(0, o.shape[0], 128):
        for br in branches:
            out, used = _far_chunk(*blobs[br], br, o, d, vr, ray0, act)
            outs[br].append(out)
            seq.append((br, used))
    return {br: torch.cat(v) for br, v in outs.items()}, seq


@pytest.mark.parametrize("n", [77, 300])
@pytest.mark.parametrize("act", ["relu", "softplus"])
@pytest.mark.parametrize("branch", ["head", "torso"])
def test_far_ring_walk_matches_the_plain_version(packed, branch, act, n):
    """far_head (NS_HEAD_TRUNK slabs a chunk, the sigma rows) and far_torso
    (NS_TORSO slabs, the rgb rows) walked chunk by chunk over a ragged ray
    count, under one chunk or over several, give the plain versions' sh [n,
    1] and ct [n, 3]."""
    o, d, vr = _far_inputs(n)
    outs, seq = _far_walk(packed, (branch,), o, d, vr, act)
    ns = _const("NS_HEAD_TRUNK" if branch == "head" else "NS_TORSO")
    assert seq == [(branch, ns)] * -(-n // 128)
    if branch == "head":
        want = far_head_reference(packed["head"], o, d, FAR, act)
    else:
        want = far_torso_reference(packed["torso"], o, d, FAR, vr, act)
    assert outs[branch].shape == want.shape
    torch.testing.assert_close(outs[branch], want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n", [77, 300])
def test_far_joint_walk_is_the_head_walk_then_the_torso_walk(packed, n):
    """far_joint's walk takes, per chunk, the head's 60 slabs then the
    torso's 84, as its producer issues them (far_eval.cu far_block), and
    equals the two walks alone bit for bit."""
    src = (_build.CSRC / "far_eval.cu").read_text()
    assert '#include "field_wgmma.cuh"' in src
    assert re.findall(r"ring\.produce\([^;]*\);", src) == [
        "ring.produce(p.w_h, NS_HEAD_TRUNK, 1);", "ring.produce(p.w_t, NS_TORSO, 1);"]
    o, d, vr = _far_inputs(n)
    joint, seq = _far_walk(packed, ("head", "torso"), o, d, vr, "relu")
    assert seq == [("head", 60), ("torso", 84)] * -(-n // 128)
    assert (_const("NS_HEAD_TRUNK"), _const("NS_TORSO")) == (60, 84)
    for br in ("head", "torso"):
        alone, _ = _far_walk(packed, (br,), o, d, vr, "relu")
        assert torch.equal(joint[br], alone[br])
