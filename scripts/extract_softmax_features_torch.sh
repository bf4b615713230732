#!/usr/bin/env bash
# The PyTorch port's run (counterpart of scripts/extract_softmax_features.sh): the same
# runs through `python -m transductive_clip_tpu_torch.cli`, on the card.
# opts="..." appends further --opts to every run: opts="data_parallel True"
# spreads each run over every visible card (the CLI starts a worker per
# card; add "tp 2" to split the classes too).
# Extract softmax features (T per main config) for every dataset split.
# Mirrors the reference protocol script (reference: scripts/extract_softmax_features.sh).
set -e
method=${method:-hard_em_dirichlet}
for dataset in sun397 caltech101 food101 ucf101 flowers102 dtd eurosat fgvcaircraft oxfordpets stanfordcars imagenet; do
    python -m transductive_clip_tpu_torch.cli --opts batch_size 1 number_tasks 1 dataset ${dataset} shots 0 \
        use_softmax_feature True method ${method} ${opts}
done
