"""Host time of a pass's normalisation and softmaxes (ms/pass): the port's
span ``extract.softmax`` (eval/extraction.py: the fetched embeddings
L2-normalised and the softmax against the text features at T, in fp32 on
the host), summed over the window's passes, over the passes."""


def read(rec):
    phases = rec.get("phases") or {}
    if "extract.softmax" not in phases or not rec.get("passes"):
        return None
    return 1e3 * phases["extract.softmax"] / rec["passes"]
