"""The reference's ``{:06d}.tar`` layout written from the port's state
dicts: the inverse of dfanerf_torch/compat/torch_ckpt.py's converters, kept
beside the tests (the package has none, as the reference package has none).
Used by tests/test_torch_reference_ckpt.py and by chip_smoke.py's
phase_reference_ckpt."""

import torch

# The reference's submodule names of each signal net, by the port's (the
# decoder's are the same in both); the entries the reference's .tar holds
# besides the five nets.
REF_RENAMES = {"audnet": {"fc1": "encoder.0", "fc2": "encoder.2", "fc3": "encoder.4"},
               "expnet": {"fc1": "encoder.0", "fc2": "encoder.2"},
               "audattnet": {**{f"conv{i + 1}": f"attentionConvNet.{2 * i}" for i in range(5)},
                             "att_fc": "attentionNet.0"}}
REF_RENAMES["poseattnet"] = REF_RENAMES["audattnet"]
REF_ENTRIES = {"decoder": "network_decoder_state_dict", "audnet": "network_AudNet_state_dict",
               "expnet": "network_ExpNet_state_dict", "audattnet": "network_AudAttNet_state_dict",
               "poseattnet": "network_PoseAttNet_state_dict"}


def reference_tar(nets, z_shape, z_app, step):
    """The reference's 10-entry .tar dict: each net's state dict in the
    port's keys (``nets``: params key -> state dict) under the reference's
    keys; the latents [2 * n_obj, z] as [1, 2 * n_obj, z]; global_step; and
    two fresh optimizer states that no loader reads."""
    out = {"global_step": int(step), "z_shape": z_shape[None].detach().cpu().clone(),
           "z_app": z_app[None].detach().cpu().clone()}
    for key, sd in nets.items():
        ren = REF_RENAMES.get(key, {})
        out[REF_ENTRIES[key]] = {ren.get(k.split(".")[0], k.split(".")[0]) + k[k.index("."):]:
                                 v.detach().cpu().clone() for k, v in sd.items()}
    adam = torch.optim.Adam([torch.zeros(1)]).state_dict()
    out["optimizer_state_dict"] = out["optimizer_Aud_state_dict"] = adam
    return out
