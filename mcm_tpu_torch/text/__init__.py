from mcm_tpu_torch.text.tokenizer import CLIPTokenizer  # noqa: F401
from mcm_tpu_torch.text.prompts import (DEFAULT_TEMPLATE,  # noqa: F401
                                        OPENAI_IMAGENET_TEMPLATES,
                                        build_prompts)
