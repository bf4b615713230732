#!/usr/bin/env bash
# The PyTorch port's run (counterpart of scripts/test_few_shot.sh): the same
# runs through `python -m transductive_clip_tpu_torch.cli`, on the card.
# opts="..." appends further --opts to every run: opts="data_parallel True"
# spreads each run over every visible card (the CLI starts a worker per
# card; add "tp 2" to split the classes too).
# Paper protocol: 1000 few-shot tasks (default 4-shot), batches of 100.
# (reference: scripts/test_few_shot.sh)
set -e
n_query=75
s=${shots:-4}
for method in hard_em_dirichlet em_dirichlet paddle alpha_tim laplacian_shot bdcspn; do
  for dataset in "$@"; do
    python -m transductive_clip_tpu_torch.cli --opts batch_size 100 number_tasks 1000 dataset ${dataset} shots ${s} \
        n_query ${n_query} save_results True seed 0 method ${method} \
        used_test_set test use_softmax_feature True ${opts}
  done
done
