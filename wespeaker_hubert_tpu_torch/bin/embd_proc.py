"""Embedding-processing-chain CLI: prep / apply / update.

Counterpart of `wespeaker_hubert_tpu/bin/embd_proc.py`:

    python -m wespeaker_hubert_tpu_torch.bin.embd_proc prep --chain "mean-subtract | \\
        length-norm | lda --dim 100 | length-norm" --emb train.npz --utt2spk utt2spk \\
        --out chain.npz [--device cuda|cpu]
    python -m wespeaker_hubert_tpu_torch.bin.embd_proc apply --chain_path chain.npz \\
        --emb in.npz --out out.npz [--device ...]
    python -m wespeaker_hubert_tpu_torch.bin.embd_proc update --chain_path chain.npz \\
        --emb indomain.npz --out chain_indomain.npz [--device ...]

`prep` fits a chain string (backend/processing.py) on training embeddings,
`apply` transforms an embedding set (saved as float32, as the JAX package
saves it), `update` refits the mean-subtraction links on new-domain
embeddings and keeps the others.  The chain runs in float64 on the device.
"""

from __future__ import annotations

import numpy as np

from ..backend.processing import EmbeddingProcessingChain, _MeanSubtraction
from ..utils.embeddings import load_embeddings, save_embeddings

__all__ = ["prep_chain", "apply_chain", "update_chain"]


def _read_utt2spk(path):
    return {u: s for u, s in (ln.split()[:2] for ln in open(path))}


def prep_chain(chain_string, emb_path, out_path, utt2spk=None, device="cuda"):
    keys, emb = load_embeddings(emb_path)
    chain = EmbeddingProcessingChain(device=device).fit(
        chain_string, emb,
        utt2spk=_read_utt2spk(utt2spk) if utt2spk else None,
        keys=keys,
    )
    chain.save(out_path)
    return chain


def apply_chain(chain_path, emb_path, out_path, device="cuda"):
    chain = EmbeddingProcessingChain.load(chain_path, device=device)
    keys, emb = load_embeddings(emb_path)
    save_embeddings(out_path, keys, chain(emb).cpu().numpy().astype(np.float32))
    return len(keys)


def update_chain(chain_path, emb_path, out_path, device="cuda"):
    """Refit the mean-subtraction links on new-domain embeddings, keeping
    the other links."""
    chain = EmbeddingProcessingChain.load(chain_path, device=device)
    _, emb = load_embeddings(emb_path)
    current = EmbeddingProcessingChain(device=chain.device)(emb)  # float64 rows, no link
    new_links = []
    for method, fn in chain.links:
        if method == "mean-subtract":
            fn = _MeanSubtraction(current.mean(0))
        new_links.append((method, fn))
        current = fn(current)
    chain.links = new_links
    chain.save(out_path)
    return chain


def main():
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("prep")
    s.add_argument("--chain", required=True)
    s.add_argument("--emb", required=True)
    s.add_argument("--out", required=True)
    s.add_argument("--utt2spk", default=None)

    for name in ("apply", "update"):
        s = sub.add_parser(name)
        s.add_argument("--chain_path", required=True)
        s.add_argument("--emb", required=True)
        s.add_argument("--out", required=True)
    for s in sub.choices.values():
        s.add_argument("--device", default="cuda", help="cuda (default) or cpu")

    args = p.parse_args()
    if args.cmd == "prep":
        prep_chain(args.chain, args.emb, args.out, args.utt2spk, device=args.device)
    elif args.cmd == "apply":
        print(apply_chain(args.chain_path, args.emb, args.out, device=args.device))
    else:
        update_chain(args.chain_path, args.emb, args.out, device=args.device)


if __name__ == "__main__":
    main()
