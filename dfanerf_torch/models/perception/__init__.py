"""The perception nets (port of dfanerf_tpu/models/perception): the
preprocessing DAG's BlazeFace, HRNet landmark net, GhostNet eye net, BiSeNet
face parser and RAFT-small, and the landmark model zoo (mobilenet,
shufflenet, u2net, ghostnet_face, zoo_extra; RAFT-basic and
ImportanceWeights in raft), as NCHW ``nn.Module``s whose state-dict keys
are the reference checkpoints' keys."""
