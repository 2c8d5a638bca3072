"""Model stacks of the port (`repro.models` counterparts), forward and
serving paths: `transformer` (dense and MoE decoder LM, prefill and decode
with a static kv cache), `deepfm`, `gnn` (GCN, GIN, GatedGCN) and
`dimenet`. Their keyed reductions run on the hand-written kernels through
`kernels.ops`: attention on the flash kernel, embedding sums on
`embedding_bag`, segment sums and maxima on `segment_reduce`."""
