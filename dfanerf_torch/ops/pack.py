"""Fold frame constants into the decoder weights for the fused render kernel
(port of dfanerf_tpu/ops/pack.py pack_field_weights).

- Contributions constant over a frame — the signal slice of fc_in /
  fc_p_skips (head), the z_shape injections (fc_z, fc_z_skips) and the z_app
  view injection (fc_z_view) — are folded into biases.
- Matrices keep the reference package's [in, out] layout, zero-padded (PE 60
  -> 64 rows) and cast to ``param_dtype``; folded biases stay float32.
- sigma_out (256 -> 1) and feat_view (256 -> 256) are fused into one
  [256, 384] matrix: column 0 is sigma, columns 128:384 the view feature.
- The torso's deformation field is packed in its 128-wide block-diagonal
  form with the signal's contribution folded into its first-layer and skip
  biases; the torso trunk reads the deformed 128-wide input p'.
"""

from __future__ import annotations

from typing import Dict

import torch

from dfanerf_torch.models.decoder import Decoder

PE_DIM = 60          # 3 * 10 freqs * 2
PE_PAD = 64          # padded PE width
DEFORM_HIDDEN = 128  # merged block-diagonal deform width


def _pad_rows(w: torch.Tensor, rows: int) -> torch.Tensor:
    return torch.cat([w, w.new_zeros((rows - w.shape[0], w.shape[1]))], dim=0)


@torch.no_grad()
def pack_field_weights(
    decoder: Decoder,
    signal: torch.Tensor,
    z_shape: torch.Tensor,
    z_app: torch.Tensor,
    branch: str,
    param_dtype: torch.dtype = torch.bfloat16,
) -> Dict[str, torch.Tensor]:
    """Kernel operands for one field of one frame.

    signal: [dim_signal] ('head') or [dim_et_embed] ('torso').
    Returns w_in [64|128, 256], b_in [256], w_blocks [7, 256, 256],
    b_blocks [7, 256], w_skip [64|128, 256], b_skip [256], w_sf [256, 384],
    b_sf [384], w_out [256, 128] (rgb cols 0:3), b_out [128], w_view [24, 256],
    b_view [256]; the torso adds d_w1 [64, 128], d_b1, d_wk [4, 128, 128],
    d_bk [4, 128], d_wskip [64, 128], d_bskip, d_wout [128, 128], d_bout and
    sig_pad [128] (signal at cols 60:60+dim_et_embed).
    """
    if branch not in ("head", "torso"):
        raise ValueError(f"unknown branch {branch!r}")
    cfg = decoder.cfg
    # the kernels evaluate the octave encoding in-register (the slot-replicated
    # sin); the gauss mode runs through Decoder.forward only
    if cfg.positional_encoding != "normal":
        raise ValueError("the fused kernels support positional_encoding='normal' only")
    f32 = torch.float32
    H = cfg.hidden_size
    sig = signal.to(f32)

    def w(layer):  # [in, out] float32
        return layer.weight.detach().t().to(f32)

    def b(layer):
        return layer.bias.detach().to(f32)

    def cast(m):
        return m.to(param_dtype)

    if branch == "head":
        fc_in, fc_skip, d_sig = decoder.fc_in, decoder.fc_p_skips[0], cfg.dim_signal
    else:
        fc_in, fc_skip, d_sig = decoder.fc_in_torso, decoder.fc_p_skips_torso[0], cfg.dim_et_embed

    w_in_pe = w(fc_in)[:PE_DIM]
    w_in_sig = w(fc_in)[PE_DIM:PE_DIM + d_sig]
    w_skip_pe = w(fc_skip)[:PE_DIM]
    w_skip_sig = w(fc_skip)[PE_DIM:PE_DIM + d_sig]

    z_s = z_shape.to(f32)
    b_in = b(fc_in) + z_s @ w(decoder.fc_z) + b(decoder.fc_z)
    b_skip = b(fc_skip) + z_s @ w(decoder.fc_z_skips[0]) + b(decoder.fc_z_skips[0])
    if branch == "head":
        b_in = b_in + sig @ w_in_sig
        b_skip = b_skip + sig @ w_skip_sig

    dev = w_in_pe.device
    w_sf = torch.zeros((H, 384), dtype=f32, device=dev)
    w_sf[:, 0] = w(decoder.sigma_out)[:, 0]
    w_sf[:, 128:384] = w(decoder.feat_view)
    b_sf = torch.zeros((384,), dtype=f32, device=dev)
    b_sf[0] = b(decoder.sigma_out)[0]
    b_sf[128:384] = b(decoder.feat_view) + z_app.to(f32) @ w(decoder.fc_z_view) + b(decoder.fc_z_view)

    w_out = torch.zeros((H, 128), dtype=f32, device=dev)
    w_out[:, :3] = w(decoder.feat_out)
    b_out = torch.zeros((128,), dtype=f32, device=dev)
    b_out[:3] = b(decoder.feat_out)

    packed = {
        "w_in": cast(_pad_rows(w_in_pe, PE_PAD)),
        "b_in": b_in,
        "w_blocks": torch.stack([cast(w(blk)) for blk in decoder.blocks]),
        "b_blocks": torch.stack([b(blk) for blk in decoder.blocks]),
        "w_skip": cast(_pad_rows(w_skip_pe, PE_PAD)),
        "b_skip": b_skip,
        "w_sf": cast(w_sf),
        "b_sf": b_sf,
        "w_out": cast(w_out),
        "b_out": b_out,
        "w_view": w(decoder.fc_view),
        "b_view": b(decoder.fc_view),
    }

    if branch == "torso" and cfg.use_deformation_field:
        dn = decoder.deform_net
        be, bs = dn.blocks_embed, dn.blocks_signal
        w1 = torch.cat([w(be[0]), w(bs[0])], dim=1)
        b1 = torch.cat([b(be[0]), b(bs[0])]) + sig @ w1[PE_DIM:]
        es, ss = dn.fc_embed_skips[0], dn.fc_signal_skips[0]
        wsk = torch.block_diag(w(es), w(ss))
        bsk = torch.cat([b(es), b(ss)]) + sig @ wsk[PE_DIM:]
        wk = torch.stack([torch.block_diag(w(be[i]), w(bs[i])) for i in range(1, len(be))])
        bk = torch.stack([torch.cat([b(be[i]), b(bs[i])]) for i in range(1, len(be))])
        wout = torch.block_diag(w(dn.out_embed), w(dn.out_signal))
        bout = torch.cat([b(dn.out_embed), b(dn.out_signal)])
        wout = torch.cat([wout, wout.new_zeros((DEFORM_HIDDEN, 128 - wout.shape[1]))], dim=1)
        bout = torch.cat([bout, bout.new_zeros((128 - bout.shape[0],))])

        sig_pad = torch.zeros((128,), dtype=f32, device=dev)
        sig_pad[60:60 + d_sig] = sig
        w_in128 = torch.zeros((128, H), dtype=f32, device=dev)
        w_in128[:PE_DIM] = w_in_pe
        w_in128[60:60 + d_sig] = w_in_sig
        w_skip128 = torch.zeros((128, H), dtype=f32, device=dev)
        w_skip128[:PE_DIM] = w_skip_pe
        w_skip128[60:60 + d_sig] = w_skip_sig
        packed["w_in"] = cast(w_in128)
        packed["w_skip"] = cast(w_skip128)
        packed.update({
            "d_w1": cast(_pad_rows(w1[:PE_DIM], PE_PAD)),
            "d_b1": b1,
            "d_wk": cast(wk),
            "d_bk": bk,
            "d_wskip": cast(_pad_rows(wsk[:PE_DIM], PE_PAD)),
            "d_bskip": bsk,
            "d_wout": cast(wout),
            "d_bout": bout,
            "sig_pad": sig_pad,
        })
    return packed
