from .tokenizer import Tokenizer
from .chat import (
    ChatTemplateGenerator,
    ChatItem,
    GeneratedChat,
    TokenizerChatStops,
    TemplateType,
    template_type_from_name,
    eos_piece_of,
    chat_generator_for,
)
from .eos import EosDetector, EosResult
from .sampler import Sampler
