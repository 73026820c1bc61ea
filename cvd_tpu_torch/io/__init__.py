from cvd_tpu_torch.io.from_flax import state_dict_from_flax
from cvd_tpu_torch.io.tokenizer import HashTokenizer
