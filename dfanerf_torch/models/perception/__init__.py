"""The preprocessing DAG's perception nets (port of
dfanerf_tpu/models/perception): BlazeFace, the HRNet landmark net, the
GhostNet eye net, the BiSeNet face parser and RAFT-small, as NCHW
``nn.Module``s whose state-dict keys are the reference checkpoints' keys."""
