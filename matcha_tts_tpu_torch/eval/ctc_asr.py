"""A small CTC speech recogniser over log-mels: the in-repo judge of
intelligibility.

A dilated-conv CTC model over the log-mel features the rest of the package
produces (`ops/stft.py`), small enough to train from scratch on an in-repo
corpus, and a drop-in `evaluate_wer` judge (`wav_asr_callable`).  A trained
judge is a `.npz` in the JAX package's format (`save_ctc_asr` /
`load_ctc_asr`), so each package reads the other's files; the committed
`tests/golden/trained/ctc_judge.npz` is a 3-member ensemble, decoded member
by member and then voted (`transcribe_mels`).

The module's `state_dict` names are the JAX tree's paths (`in_norm`,
`stem`, `blocks.{i}.{conv,norm}`, `head`).  Numerics as the JAX package's:
padding frames are set to `MEL_PAD_VALUE` before the input LayerNorm (eps
1e-5), the GELUs are the tanh approximation (`jax.nn.gelu`'s default), the
stem is padded by (k - 1) // 2, so it gives ceil(T / stride) frames, and
the loss is the CTC negative log-likelihood per sequence over its label
count, averaged (`F.ctc_loss` on log-softmax outputs; it equals optax's
for every feasible alignment).
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from matcha_tts_tpu_torch.models.nn import Conv1d, Linear, Norm, layer_norm
from matcha_tts_tpu_torch.ops.masking import sequence_mask

# character alphabet: CTC blank = 0, 'a'..'z' = 1..26, space = 27
BLANK_ID = 0
SPACE_ID = 27
ALPHABET = "abcdefghijklmnopqrstuvwxyz "
VOCAB_SIZE = 1 + len(ALPHABET)

# log(1e-5), the log-mel floor: what silence looks like in feature space,
# used to pad beyond mel_lengths
MEL_PAD_VALUE = -11.512925


def encode_chars(text: str) -> np.ndarray:
    """Lowercased a-z / space text -> label ids (no blanks); other
    characters are dropped."""
    ids = []
    for ch in text.lower():
        if ch == " ":
            ids.append(SPACE_ID)
        elif "a" <= ch <= "z":
            ids.append(ord(ch) - ord("a") + 1)
    return np.asarray(ids, np.int32)


def decode_chars(ids: Sequence[int]) -> str:
    out = []
    for i in ids:
        if i == SPACE_ID:
            out.append(" ")
        elif 1 <= i <= 26:
            out.append(chr(ord("a") + i - 1))
    return "".join(out)


@dataclasses.dataclass(frozen=True)
class CTCASRConfig:
    n_mels: int = 80
    vocab_size: int = VOCAB_SIZE
    hidden: int = 192
    kernel: int = 5
    stride: int = 2  # the stem's time reduction
    dilations: Tuple[int, ...] = (1, 2, 4, 1)


class _Block(nn.Module):
    def __init__(self, hidden: int, kernel: int, generator: torch.Generator):
        super().__init__()
        self.conv = Conv1d(hidden, hidden, kernel, generator=generator)
        self.norm = Norm(hidden)


class CTCASR(nn.Module):
    """(B, T, n_mels) log-mel -> (B, ceil(T / stride), vocab) logits, with
    random weights drawn from `seed` (kaiming-uniform convs and head, as the
    JAX package's init), on `device`."""

    def __init__(self, cfg: CTCASRConfig = CTCASRConfig(), *, seed: int = 0, device="cuda"):
        super().__init__()
        self.cfg = cfg
        g = torch.Generator().manual_seed(seed)
        self.in_norm = Norm(cfg.n_mels)
        self.stem = Conv1d(cfg.n_mels, cfg.hidden, cfg.kernel, generator=g)
        self.blocks = nn.ModuleList(_Block(cfg.hidden, cfg.kernel, g) for _ in cfg.dilations)
        self.head = Linear(cfg.hidden, cfg.vocab_size, generator=g)
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.head.weight.device

    def forward(self, mel: torch.Tensor, mel_lengths: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        mask = sequence_mask(mel_lengths, mel.shape[1])[..., None]
        mel = torch.where(mask, mel, MEL_PAD_VALUE)
        x = layer_norm(mel, self.in_norm.gamma, self.in_norm.beta)
        pad = (cfg.kernel - 1) // 2
        x = F.gelu(self.stem(x, stride=cfg.stride, padding=pad), approximate="tanh")
        for blk, dil in zip(self.blocks, cfg.dilations):
            h = layer_norm(x, blk.norm.gamma, blk.norm.beta)
            h = F.gelu(blk.conv(h, padding=pad * dil, dilation=dil), approximate="tanh")
            x = x + h
        return self.head(x)


def out_lengths(mel_lengths, cfg: CTCASRConfig):
    """Frame count after the strided stem: ceil(T / stride)."""
    return (mel_lengths + cfg.stride - 1) // cfg.stride


def ctc_logits(model: CTCASR, mel: torch.Tensor, mel_lengths: torch.Tensor) -> torch.Tensor:
    """(B, T, n_mels) log-mel -> (B, ceil(T / stride), vocab) logits.
    Padding frames are set to the mel floor first, so the bucket size never
    changes the valid frames' logits."""
    return model(mel, mel_lengths)


def ctc_asr_loss(model: CTCASR, mel: torch.Tensor, mel_lengths: torch.Tensor,
                 labels: torch.Tensor, label_lengths: torch.Tensor) -> torch.Tensor:
    """Mean over the batch of the CTC loss per sequence divided by its label
    count (at least 1).  An infeasible alignment gives inf here, where optax
    clamps it."""
    logits = ctc_logits(model, mel, mel_lengths)
    log_probs = F.log_softmax(logits.float(), dim=-1).transpose(0, 1)  # (T, B, V)
    per_seq = F.ctc_loss(log_probs, labels.long(), out_lengths(mel_lengths, model.cfg).long(),
                         label_lengths.long(), blank=BLANK_ID, reduction="none")
    return torch.mean(per_seq / torch.clamp(label_lengths, min=1))


def train_ctc_asr(mels: np.ndarray, mel_lengths: np.ndarray, labels: np.ndarray,
                  label_lengths: np.ndarray, cfg: CTCASRConfig, steps: int = 400,
                  lr: float = 3e-4, log_every: int = 0, *, seed: int = 0,
                  device="cuda") -> CTCASR:
    """Full-batch Adam (betas 0.9, 0.999, eps 1e-8: optax.adam's update) from
    random weights drawn from `seed`; `log_every > 0` prints the loss."""
    model = CTCASR(cfg, seed=seed, device=device)
    model.train()
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    mel = torch.as_tensor(mels, dtype=torch.float32, device=device)
    mel_lengths = torch.as_tensor(mel_lengths, device=device).long()
    labels = torch.as_tensor(labels, device=device).long()
    label_lengths = torch.as_tensor(label_lengths, device=device).long()
    for step in range(1, steps + 1):
        loss = ctc_asr_loss(model, mel, mel_lengths, labels, label_lengths)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if log_every and (step % log_every == 0 or step == 1):
            print(f"  asr step {step}: ctc_loss/char {float(loss):.4f}")
    model.eval()
    return model


def greedy_decode(logits, lengths) -> List[str]:
    """Best-path CTC decode: argmax, collapse repeats, drop blanks."""
    best = np.asarray(torch.as_tensor(logits).argmax(dim=-1).cpu())
    lengths = np.asarray(torch.as_tensor(lengths).cpu())
    texts = []
    for b in range(best.shape[0]):
        seq = best[b, :int(lengths[b])]
        collapsed = [int(s) for i, s in enumerate(seq)
                     if s != BLANK_ID and (i == 0 or s != seq[i - 1])]
        texts.append(decode_chars(collapsed))
    return texts


def _edit_distance(a: str, b: str) -> int:
    """Character Levenshtein distance."""
    if a == b:
        return 0
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[-1] + 1, prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def vote_hypotheses(member_hyps: List[List[str]]) -> List[str]:
    """Ensemble vote: per row, the medoid of the members' hypotheses (the
    least total edit distance to the others; of equal costs, the first
    member's).  `member_hyps[m][b]` is member m's decode of row b.  A
    member's spurious emissions depend on its init, so the medoid drops
    them wherever a majority agrees."""
    out = []
    for b in range(len(member_hyps[0])):
        cands = [h[b] for h in member_hyps]
        costs = [sum(_edit_distance(c, o) for o in cands) for c in cands]
        out.append(cands[int(np.argmin(costs))])
    return out


Judge = Union[CTCASR, List[CTCASR]]


@torch.no_grad()
def transcribe_mels(model: Judge, mels, mel_lengths) -> List[str]:
    """(B, T, n_mels) log-mel batch (numpy or tensors) -> hypotheses.
    `model` is one judge or a list of them (an ensemble: each member
    decodes, then `vote_hypotheses` picks per row)."""
    if isinstance(model, (list, tuple)):
        return vote_hypotheses([transcribe_mels(m, mels, mel_lengths) for m in model])
    mel = torch.as_tensor(mels, dtype=torch.float32).to(model.device)
    lengths = torch.as_tensor(mel_lengths).long().to(model.device)
    logits = ctc_logits(model, mel, lengths)
    return greedy_decode(logits.cpu(), out_lengths(lengths, model.cfg).cpu())


def wav_asr_callable(model: Judge, audio, frame_bucket: int):
    """The `evaluate_wer` judge: wav16k -> hypothesis string.  Resamples to
    the judge's rate (`audio`, an AudioConfig), takes the log-mel of
    `ops/stft.py` in one fixed bucket of `frame_bucket` frames, and decodes."""
    from matcha_tts_tpu_torch.eval.wer import resample
    from matcha_tts_tpu_torch.ops.stft import log_mel_spectrogram

    device = (model[0] if isinstance(model, (list, tuple)) else model).device
    pad = int((audio.n_fft - audio.hop_length) / 2)
    wav_bucket = (frame_bucket - 1) * audio.hop_length + audio.n_fft - 2 * pad

    def asr(wav16k: np.ndarray) -> str:
        wav = resample(wav16k, 16000, audio.sample_rate)[:wav_bucket]
        batch = torch.zeros((1, wav_bucket), dtype=torch.float32)
        batch[0, :len(wav)] = torch.from_numpy(wav)
        mel = log_mel_spectrogram(batch.to(device), audio.sample_rate, audio.n_fft,
                                  audio.n_mels, audio.hop_length, audio.win_length,
                                  audio.f_min, audio.f_max).transpose(1, 2).contiguous()
        n = min(1 + (len(wav) + 2 * pad - audio.n_fft) // audio.hop_length, frame_bucket)
        mel[0, n:] = MEL_PAD_VALUE
        return transcribe_mels(model, mel, torch.tensor([n]))[0]

    return asr


# ---------------------------------------------------------------------------
# persistence: the JAX package's .npz ("/"-joined tree paths, list indices as
# digits, the config as JSON bytes under "__config__")
# ---------------------------------------------------------------------------


def save_ctc_asr(path, model: Judge) -> None:
    """Write a judge (or an ensemble, as a list at the top level) and its
    config to one .npz."""
    from matcha_tts_tpu_torch.params.from_jax import flatten_tree, to_jax_tree

    members = model if isinstance(model, (list, tuple)) else None
    tree = [to_jax_tree(m) for m in members] if members else to_jax_tree(model)
    cfg = (members[0] if members else model).cfg
    flat = {k.replace(".", "/"): v for k, v in flatten_tree(tree).items()}
    flat["__config__"] = np.frombuffer(json.dumps(dataclasses.asdict(cfg)).encode(), np.uint8)
    np.savez(path, **flat)


def load_ctc_asr(path, device="cuda") -> Tuple[Judge, CTCASRConfig]:
    """Read a judge saved by either package -> (CTCASR, or a list of them
    for an ensemble file, on `device`; the config)."""
    from matcha_tts_tpu_torch.params.from_jax import copy_jax_tree, read_npz

    with np.load(path) as data:
        raw = json.loads(bytes(data["__config__"]).decode())
    raw["dilations"] = tuple(raw["dilations"])
    cfg = CTCASRConfig(**raw)
    tree = read_npz(path)

    def build(t):
        return copy_jax_tree(CTCASR(cfg, device="cpu"), t).to(device).eval()

    return ([build(t) for t in tree] if isinstance(tree, list) else build(tree)), cfg
