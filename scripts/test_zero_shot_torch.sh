#!/usr/bin/env bash
# The PyTorch port's run (counterpart of scripts/test_zero_shot.sh): the same
# runs through `python -m transductive_clip_tpu_torch.cli`, on the card.
# opts="..." appends further --opts to every run: opts="data_parallel True"
# spreads each run over every visible card (the CLI starts a worker per
# card; add "tp 2" to split the classes too).
# Paper protocol: 1000 zero-shot tasks, batches of 100, n_query 75, seed 0.
# (reference: scripts/test_zero_shot.sh)
set -e
n_query=75
for use_softmax in True False; do
  for method in hard_em_dirichlet em_dirichlet soft_kmeans em_gaussian_cov kl_kmeans em_gaussian hard_kmeans inductive_clip; do
    # EM-Dirichlet variants require softmax features
    if [ "$use_softmax" = "False" ] && { [ "$method" = "em_dirichlet" ] || [ "$method" = "hard_em_dirichlet" ]; }; then
      continue
    fi
    for dataset in "$@"; do
      python -m transductive_clip_tpu_torch.cli --opts batch_size 100 number_tasks 1000 dataset ${dataset} shots 0 \
          n_query ${n_query} save_results True seed 0 method ${method} \
          used_test_set test use_softmax_feature ${use_softmax} ${opts}
    done
  done
done
