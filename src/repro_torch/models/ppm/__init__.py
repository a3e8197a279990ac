from repro_torch.models.ppm.trunk import PPMConfig, init_trunk, trunk_apply, block_apply
from repro_torch.models.ppm.model import (init_ppm, ppm_forward,
                                          pair_activation_inventory,
                                          score_tensor_shape)
from repro_torch.models.ppm.structure import tm_score, rmsd, kabsch_align
