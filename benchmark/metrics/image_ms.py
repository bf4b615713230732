"""Wall clock of the window per image of its completed passes (ms/image)."""


def read(rec):
    if not rec.get("images"):
        return None
    return 1e3 * rec["window_s"] / rec["images"]
