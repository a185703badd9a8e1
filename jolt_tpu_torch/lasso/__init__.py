from .surge import (SurgePreprocessing, SurgeProof, generate_witness,
                    surge_prove, surge_verify)

__all__ = ["SurgePreprocessing", "SurgeProof", "generate_witness",
           "surge_prove", "surge_verify"]
