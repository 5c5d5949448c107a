from lrcn_tpu_torch.core.vocab import BOS_ID, EOS_ID, UNK_ID, Vocab  # noqa: F401
