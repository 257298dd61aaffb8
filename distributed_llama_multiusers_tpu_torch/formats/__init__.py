from .model_file import (
    ModelHeader,
    ArchType,
    HiddenAct,
    RopeType,
    load_model_header,
    write_model_header,
    iter_model_tensors,
    MODEL_MAGIC,
)
from .tokenizer_file import (
    TokenizerData,
    load_tokenizer_file,
    write_tokenizer_file,
    TOKENIZER_MAGIC,
)
