#!/usr/bin/env bash
# The PyTorch port's run (counterpart of scripts/opt_parameters.sh): the same
# runs through `python -m transductive_clip_tpu_torch.cli`, on the card.
# opts="..." appends further --opts to every run: opts="data_parallel True"
# spreads each run over every visible card (the CLI starts a worker per
# card; add "tp 2" to split the classes too).
# Validation grid sweeps for the tunable few-shot methods
# (reference: scripts/opt_parameters.sh). Results append to
# results_few_shot/val/<dataset>/<METHOD>_<features>_s<shots>.txt.
set -e
n_query=35
number_tasks=5
batch_size=5
k_eff=5
for dataset in "$@"; do
  for s in 1 2 4 8 16; do
    for alpha_value in 1.5 2.0 2.5 3.0 3.5 4.0 4.5 5.0 5.5 6.0 6.5 7.0; do
      python -m transductive_clip_tpu_torch.cli --opts method alpha_tim batch_size ${batch_size} number_tasks ${number_tasks} \
          dataset ${dataset} alpha_value ${alpha_value} shots ${s} n_query ${n_query} k_eff ${k_eff} \
          save_results True seed 0 used_test_set val use_softmax_feature True ${opts}
    done
    for temp in 1.0 3.0 5.0 10.0 20.0 30.0 40.0 50.0 60.0; do
      python -m transductive_clip_tpu_torch.cli --opts method bdcspn batch_size ${batch_size} number_tasks ${number_tasks} \
          dataset ${dataset} temp ${temp} shots ${s} n_query ${n_query} k_eff ${k_eff} \
          save_results True seed 0 used_test_set val use_softmax_feature True ${opts}
    done
    for lambd in 0.0 1.0 2.0 5.0 10.0 20.0 35.0 50.0 100.0; do
      python -m transductive_clip_tpu_torch.cli --opts method paddle batch_size ${batch_size} number_tasks ${number_tasks} \
          dataset ${dataset} lambd ${lambd} shots ${s} n_query ${n_query} k_eff ${k_eff} \
          save_results True seed 0 used_test_set val use_softmax_feature True ${opts}
    done
    for lmd in 1.0 2.0 3.0 4.0 5.0 6.0 7.0 8.0 9.0; do
      python -m transductive_clip_tpu_torch.cli --opts method laplacian_shot batch_size ${batch_size} number_tasks ${number_tasks} \
          dataset ${dataset} lmd ${lmd} shots ${s} n_query ${n_query} k_eff ${k_eff} \
          save_results True seed 0 used_test_set val use_softmax_feature True ${opts}
    done
  done
done
