"""Scale-out of the port, ported from stringdecomposer_tpu/parallel/.

- `mesh`: the devices of a run (every visible GPU, or the CPU) and the
  process topology (`torch.distributed`, process topology only).
- `sharding`: data parallelism over devices: the chain DP's window axis,
  the identity kernel's pair axis and the packed finishing call's block
  axis, each shard run by the hand-written kernels on its own device.
- `multihost`: reads sharded across hosts, each writing TSV fragments that
  host 0 merges through the filesystem.

No collective rides the output path: windows, pairs and reads are
independent, and the merges are deterministic, so the bytes written are
the same at every device and host count.
"""
