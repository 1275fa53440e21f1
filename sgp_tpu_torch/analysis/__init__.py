from sgp_tpu_torch.analysis.whiteness import (AZWhitenessMultiTestResult,
                                              AZWhitenessTestResult,
                                              UndirectedEdges,
                                              az_whiteness_test,
                                              prepare_edges)

__all__ = ["AZWhitenessMultiTestResult", "AZWhitenessTestResult",
           "UndirectedEdges", "az_whiteness_test", "prepare_edges"]
