"""The 11 dataset loaders (the port's own copy of
transductive_clip_tpu/data/catalog.py; reference: src/datasets/*.py).

Eight of the reference's datasets share the CoOp split-JSON layout and
differ only in (split filename, image subdirectory, prompt template) —
the reference implements them as eight near-identical classes all
delegating to ``OxfordPets.read_split`` (reference:
src/datasets/oxfordpets.py:102-126); here they are one parameterized
loader plus a spec table. FGVCAircraft reads txt metadata (reference:
src/datasets/fgvcaircraft.py:10-47) and ImageNet a csv class map + txt
file lists (reference: src/datasets/imagenet.py:189-256).
"""

from __future__ import annotations

import csv
import functools
import json
import os

from .base import Datum, DatasetBase

# name -> (split json, image subdirectory, prompt template)
COOP_SPECS = {
    "caltech101": (
        "split_zhou_Caltech101.json", "101_ObjectCategories",
        "a photo of a {}.",
    ),
    "dtd": (
        "split_zhou_DescribableTextures.json", "images",
        "{} texture.",
    ),
    "eurosat": (
        "split_zhou_EuroSAT.json", "images",
        "a centered satellite photo of {}.",
    ),
    "flowers102": (
        "split_zhou_OxfordFlowers.json", "jpg",
        "a photo of a {}, a type of flower.",
    ),
    "food101": (
        "split_zhou_Food101.json", "images",
        "a photo of {}, a type of food.",
    ),
    "oxfordpets": (
        "split_zhou_OxfordPets.json", "images",
        "a photo of a {}, a type of pet.",
    ),
    "stanfordcars": (
        "split_zhou_StanfordCars.json", "",
        "a photo of a {}.",
    ),
    "sun397": (
        "split_zhou_SUN397.json", "SUN397",
        "a photo of a {}.",
    ),
    "ucf101": (
        "split_zhou_UCF101.json", "UCF-101-midframes",
        "a photo of a person doing {}.",
    ),
}


class CoopJsonDataset(DatasetBase):
    """CoOp-format dataset: one JSON with train/val/test lists of
    ``[relative impath, label, classname]`` rows, image paths anchored at
    an image subdirectory (reference: src/datasets/oxfordpets.py:102-126).
    """

    def __init__(self, name: str, root: str):
        split_file, image_subdir, template = COOP_SPECS[name]
        image_dir = os.path.join(root, image_subdir) if image_subdir else root
        with open(os.path.join(root, split_file)) as f:
            split = json.load(f)

        def convert(rows):
            return [
                Datum(
                    impath=os.path.join(image_dir, impath),
                    label=int(label),
                    classname=classname,
                )
                for impath, label, classname in rows
            ]

        super().__init__(
            train_x=convert(split["train"]),
            val=convert(split["val"]),
            test=convert(split["test"]),
            template=template,
        )


class FGVCAircraft(DatasetBase):
    """Aircraft variants from ``variants.txt`` +
    ``images_variant_{split}.txt`` (reference:
    src/datasets/fgvcaircraft.py:10-47)."""

    template = "a photo of a {}, a type of aircraft."

    def __init__(self, root: str):
        image_dir = os.path.join(root, "images")
        with open(os.path.join(root, "variants.txt")) as f:
            variants = [line.strip() for line in f if line.strip()]
        cname2lab = {c: i for i, c in enumerate(variants)}

        def read(split):
            items = []
            with open(os.path.join(root, f"images_variant_{split}.txt")) as f:
                for line in f:
                    parts = line.strip().split(" ")
                    if not parts[0]:
                        continue
                    classname = " ".join(parts[1:])
                    items.append(
                        Datum(
                            impath=os.path.join(image_dir, parts[0] + ".jpg"),
                            label=cname2lab[classname],
                            classname=classname,
                        )
                    )
            return items

        super().__init__(
            train_x=read("train"), val=read("val"), test=read("test"),
            template=self.template,
        )


@functools.lru_cache(maxsize=1)
def imagenet_classnames():
    """The 1000 ImageNet-1k prompt classnames, label-ordered. Vendored as
    an asset with the reference's two corrupted entries repaired
    ("fuzzy_kmeans"/"fuzzy_kmeans wheel" -> "paddle"/"paddle wheel";
    reference: src/datasets/imagenet.py:130, SURVEY.md §2.4)."""
    path = os.path.join(
        os.path.dirname(__file__), "assets", "imagenet_classnames.txt"
    )
    with open(path) as f:
        names = [line.rstrip("\n") for line in f if line.strip()]
    if len(names) != 1000:
        raise RuntimeError(
            f"imagenet_classnames asset corrupt: {len(names)} entries"
        )
    return names


class ImageNet(DatasetBase):
    """ImageNet-1k: ``idx_class_name.csv`` maps wnids to labels; train/val
    txt lists give ``wnid/imname`` rows whose images live under
    ``<root>/{train,val}/<wnid>/<imname>.JPEG``. The val list is the test
    split (reference: src/datasets/imagenet.py:189-256)."""

    template = "a photo of a {}."

    def __init__(self, root: str):
        with open(os.path.join(root, "idx_class_name.csv")) as f:
            classes_to_label = {
                row[1]: int(row[0]) for row in csv.reader(f) if row
            }
        names = imagenet_classnames()

        def read(split_file, folder):
            items = []
            with open(os.path.join(root, split_file)) as f:
                for line in f:
                    rel = line.strip().split(" ")[0]
                    if not rel:
                        continue
                    wnid, imname = rel.split("/")[0], rel.split("/")[-1]
                    label = classes_to_label[wnid]
                    items.append(
                        Datum(
                            impath=os.path.join(
                                root, folder, wnid, imname + ".JPEG"
                            ),
                            label=label,
                            classname=names[label],
                        )
                    )
            return items

        super().__init__(
            train_x=read("train.txt", "train"),
            test=read("val.txt", "val"),
            template=self.template,
        )
