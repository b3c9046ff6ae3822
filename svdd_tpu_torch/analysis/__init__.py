"""Analysis (``svdd_tpu/analysis/``): in-silico mutagenesis, gradient
attributions, attention maps and motif discovery (``interpret``), directed
evolution and Ledidi design (``design``), sequence format conversion
(``formats``) and plotting (``visualize``)."""
