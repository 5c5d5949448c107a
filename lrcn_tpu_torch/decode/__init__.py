from lrcn_tpu_torch.decode.beam import (  # noqa: F401
    beam_search,
    beam_search_grouped,
    greedy_search,
    greedy_search_grouped,
    rows_search,
)
from lrcn_tpu_torch.decode.sample import (  # noqa: F401
    best_of_n_search,
    sample_search,
)
from lrcn_tpu_torch.decode.writer import (  # noqa: F401
    caption_to_line,
    detokenize_batch,
    generate_captions,
    pick_eval_ids,
    pick_eval_ids_from_captions,
    write_candidate_files,
)
