"""Conditioned NeRF decoder and torso deformation field (port of
dfanerf_tpu/models/decoder.py).

One module holds all three input branches (head-with-signal, head-listener,
torso), as the reference's shared network does. ``Decoder.forward`` is the
port of ``apply_decoder``: a function of a flat point batch, in float32 by
default (the oracle that ops/pack.py's folded weights are tested against) or
with its trunk in ``compute_dtype`` (training's bfloat16). The deformation
field is evaluated in its 128-wide block-diagonal form, built from the
two-branch parameters on the fly.

In ``compute_dtype`` every layer runs as the reference's ``linear`` does in
that dtype: the float32 master weights are cast (so autograd carries the
gradient back to them), the product is rounded to the dtype and the bias add
rounds again (the colour layer's add excepted, see ``forward``). ``F.linear``
would fuse the add and round once; autocast would choose its own casts.

``positional_encoding='gauss'`` encodes points and view directions with the
reference's fixed seed-42 projections (core/posenc.py gauss_B_matrices),
constants of the configuration kept outside the module (one copy per
device), so the state dict is the same in both modes. Only this module
and the training renderer run it: the fused kernels evaluate the octave
encoding, and ops/pack.py refuses gauss.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from dfanerf_torch.core.posenc import gauss_B_matrices, gauss_posenc, sincos_posenc


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """Static decoder hyperparameters (defaults = shipped train_obama.sh)."""

    hidden_size: int = 256
    n_blocks: int = 8
    n_blocks_view: int = 1
    dim_signal: int = 96
    skips: Tuple[int, ...] = (4,)
    use_viewdirs: bool = True
    n_freq_posenc: int = 10
    n_freq_posenc_views: int = 4
    dim_exp: int = 256
    dim_et_embed: int = 42
    z_dim: int = 256
    rgb_out_dim: int = 3
    final_sigmoid_activation: bool = True
    downscale_p_by: float = 2.0
    use_deformation_field: bool = True
    use_expression: bool = False
    dim_w2lfeature: int = 512
    use_wav2lip: bool = False
    positional_encoding: str = "normal"  # 'normal' | 'gauss'
    gauss_dim_pos: int = 10
    gauss_dim_view: int = 4
    gauss_std: float = 4.0
    density_activation: str = "relu"

    @property
    def dim_embed(self) -> int:
        if self.positional_encoding == "gauss":
            return 3 * self.gauss_dim_pos * 2
        return 3 * self.n_freq_posenc * 2

    @property
    def dim_embed_view(self) -> int:
        if self.positional_encoding == "gauss":
            return 3 * self.gauss_dim_view * 2
        return 3 * self.n_freq_posenc_views * 2

    @property
    def n_skips(self) -> int:
        return sum(i in self.skips for i in range(self.n_blocks - 1))


def _linear(layer: nn.Linear, x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``x @ w + b``: the float32 layer, or in ``dtype`` as two rounded steps."""
    if dtype is None:
        return layer(x)
    return x @ layer.weight.to(dtype).t() + layer.bias.to(dtype)


class DeformationField(nn.Module):
    """Two parallel 64-wide MLPs (point embedding and pose signal) with a skip
    at block 4, applied residually to the torso branch's input."""

    def __init__(self, dim_embed: int, dim_signal: int, hidden_size: int = 64,
                 n_blocks: int = 7, skips: Tuple[int, ...] = (4,)):
        super().__init__()
        self.skips = skips
        d_in = dim_embed + dim_signal
        n_skips = sum(i in skips for i in range(n_blocks - 1))

        def chain():
            return nn.ModuleList(
                [nn.Linear(d_in, hidden_size)]
                + [nn.Linear(hidden_size, hidden_size) for _ in range(n_blocks - 3)]
            )

        self.blocks_embed = chain()
        self.out_embed = nn.Linear(hidden_size, dim_embed)
        self.blocks_signal = chain()
        self.out_signal = nn.Linear(hidden_size, dim_signal)
        self.fc_embed_skips = nn.ModuleList(
            [nn.Linear(dim_embed, hidden_size) for _ in range(n_skips)])
        self.fc_signal_skips = nn.ModuleList(
            [nn.Linear(dim_signal, hidden_size) for _ in range(n_skips)])

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """x [..., dim_embed + dim_signal] -> deformation of the same shape
        (the caller adds it to x); weights cast to ``dtype`` when given."""
        be, bs = self.blocks_embed, self.blocks_signal

        def cast(t):
            return t if dtype is None else t.to(dtype)

        def pair(a, b):  # (W_a ⊕ W_b as [in, out], b_a | b_b)
            return (cast(torch.block_diag(a.weight.t(), b.weight.t())),
                    cast(torch.cat([a.bias, b.bias])))

        w0 = cast(torch.cat([be[0].weight.t(), bs[0].weight.t()], dim=1))
        h = torch.relu(x @ w0 + cast(torch.cat([be[0].bias, bs[0].bias])))
        skip_idx = 0
        for idx in range(1, len(be)):
            w, b = pair(be[idx], bs[idx])
            h = torch.relu(h @ w + b)
            if (idx + 1) in self.skips and idx < len(be) - 1:
                w_skip, b_skip = pair(self.fc_embed_skips[skip_idx], self.fc_signal_skips[skip_idx])
                h = h + (x @ w_skip + b_skip)
                skip_idx += 1
        w_out, b_out = pair(self.out_embed, self.out_signal)
        return h @ w_out + b_out


# gauss_B_matrices by (gauss_dim_pos, gauss_dim_view, gauss_std, device)
_GAUSS_B = {}

_IN_LAYER = {"head": "fc_in", "head_listener": "fc_in_listener", "torso": "fc_in_torso"}
_SKIP_LAYERS = {"head": "fc_p_skips", "head_listener": "fc_p_skips_listener",
                "torso": "fc_p_skips_torso"}


class Decoder(nn.Module):
    """The shared three-branch decoder; submodule names are the reference
    package's parameter-tree keys."""

    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        if cfg.positional_encoding not in ("normal", "gauss"):
            raise ValueError(f"unknown positional_encoding {cfg.positional_encoding!r}")
        self.cfg = cfg
        H, Z = cfg.hidden_size, cfg.z_dim
        d_e, d_ev = cfg.dim_embed, cfg.dim_embed_view
        self.fc_in = nn.Linear(d_e + cfg.dim_signal, H)
        self.fc_in_listener = nn.Linear(d_e, H)
        self.fc_in_torso = nn.Linear(d_e + cfg.dim_et_embed, H)
        self.blocks = nn.ModuleList([nn.Linear(H, H) for _ in range(cfg.n_blocks - 1)])
        self.sigma_out = nn.Linear(H, 1)
        self.fc_z_view = nn.Linear(Z, H)
        self.feat_view = nn.Linear(H, H)
        self.fc_view = nn.Linear(d_ev, H)
        self.feat_out = nn.Linear(H, cfg.rgb_out_dim)
        if Z > 0:
            self.fc_z = nn.Linear(Z, H)
        if cfg.n_skips > 0:
            n = cfg.n_skips
            self.fc_z_skips = nn.ModuleList([nn.Linear(Z, H) for _ in range(n)])
            self.fc_p_skips = nn.ModuleList(
                [nn.Linear(d_e + cfg.dim_signal, H) for _ in range(n)])
            self.fc_p_skips_listener = nn.ModuleList([nn.Linear(d_e, H) for _ in range(n)])
            self.fc_p_skips_torso = nn.ModuleList(
                [nn.Linear(d_e + cfg.dim_et_embed, H) for _ in range(n)])
        if cfg.use_viewdirs and cfg.n_blocks_view > 1:
            self.blocks_view = nn.ModuleList(
                [nn.Linear(d_ev + H, H) for _ in range(cfg.n_blocks_view - 1)])
        if cfg.use_deformation_field:
            self.deform_net = DeformationField(d_e, cfg.dim_et_embed)
        if cfg.use_expression:
            self.expnet = nn.Linear(cfg.dim_exp, H)
        if cfg.use_wav2lip:
            self.w2lnet = nn.Linear(cfg.dim_w2lfeature, H)

    def _encode(self, x: torch.Tensor, view: bool) -> torch.Tensor:
        """The configured encoding of points (or unit view directions)."""
        cfg = self.cfg
        if cfg.positional_encoding == "gauss":
            key = (cfg.gauss_dim_pos, cfg.gauss_dim_view, cfg.gauss_std, x.device)
            if key not in _GAUSS_B:
                _GAUSS_B[key] = tuple(b.to(x.device) for b in gauss_B_matrices(*key[:3]))
            return gauss_posenc(x, _GAUSS_B[key][1 if view else 0], cfg.downscale_p_by)
        n = cfg.n_freq_posenc_views if view else cfg.n_freq_posenc
        return sincos_posenc(x, n, cfg.downscale_p_by)

    def forward(
        self,
        p_in: torch.Tensor,
        ray_d: Optional[torch.Tensor],
        z_shape: torch.Tensor,
        z_app: torch.Tensor,
        signal: Optional[torch.Tensor],
        branch: str,
        expression: Optional[torch.Tensor] = None,
        compute_dtype: Optional[torch.dtype] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Evaluate the decoder on points p_in [N, 3].

        signal: [dim_signal] or [N, dim_signal] ('head'), [dim_et_embed] or
        [N, dim_et_embed] ('torso'), ignored for 'head_listener'.
        compute_dtype: None runs float32; a dtype (torch.bfloat16) runs the
        layers in it, with the positional encodings computed in float32 and
        cast after, as the reference does.
        Returns feat [N, rgb_out_dim] (sigmoid'd if configured), sigma [N],
        both float32.
        """
        if branch not in _IN_LAYER:
            raise ValueError(f"unknown branch {branch!r}")
        cfg, dt = self.cfg, compute_dtype
        p = self._encode(p_in.float(), view=False)
        if dt is not None:
            p, z_shape, z_app = p.to(dt), z_shape.to(dt), z_app.to(dt)
        if branch != "head_listener":
            if signal is None:
                raise ValueError(f"branch {branch!r} needs a signal")
            sig = torch.atleast_2d(signal).to(p.dtype).expand(p.shape[0], signal.shape[-1])
            p = torch.cat([p, sig], dim=-1)
        if cfg.use_deformation_field and branch == "torso":
            p = self.deform_net(p, dt) + p

        net = _linear(getattr(self, _IN_LAYER[branch]), p, dt)
        if cfg.z_dim > 0:
            net = net + _linear(self.fc_z, z_shape, dt)
        net = torch.relu(net)

        skip_layers = getattr(self, _SKIP_LAYERS[branch], None)
        skip_idx = 0
        for idx, layer in enumerate(self.blocks):
            net = torch.relu(_linear(layer, net, dt))
            if (idx + 1) in cfg.skips and idx < len(self.blocks) - 1:
                net = net + _linear(self.fc_z_skips[skip_idx], z_shape, dt)
                net = net + _linear(skip_layers[skip_idx], p, dt)
                skip_idx += 1

        sigma = _linear(self.sigma_out, net, dt)[..., 0]
        net = _linear(self.feat_view, net, dt) + _linear(self.fc_z_view, z_app, dt)
        if expression is not None and cfg.use_expression:
            net = net + _linear(self.expnet, expression.to(net.dtype), dt)

        if cfg.use_viewdirs and ray_d is not None:
            ray_d = ray_d.float()
            ray_d = ray_d / torch.linalg.norm(ray_d, dim=-1, keepdim=True)
            rd = self._encode(ray_d, view=True)
            if dt is not None:
                rd = rd.to(dt)
            net = torch.relu(net + _linear(self.fc_view, rd, dt))
            if cfg.n_blocks_view > 1:
                for layer in self.blocks_view:
                    net = torch.relu(_linear(layer, net, dt))

        if dt is None:
            feat = self.feat_out(net)
        else:
            # the reference's jitted step keeps this last bias add in float32:
            # under XLA's excess precision the add's rounding to the compute
            # dtype goes with the cast to float32 that follows it
            w, b = self.feat_out.weight.to(dt), self.feat_out.bias.to(dt)
            feat = (net @ w.t()).float() + b.float()
        if cfg.final_sigmoid_activation:
            feat = torch.sigmoid(feat)
        return feat, sigma.float()
