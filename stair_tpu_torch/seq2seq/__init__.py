"""Seq2seq program parsers: question -> neural program (port of
``stair_tpu/seq2seq/``).

The same data contract as the JAX package's (question text in,
space-joined program tokens out, beam-5 decode with the
``program_is_valid`` filter):

  * :mod:`stair_tpu_torch.seq2seq.lstm` — attention LSTM encoder-decoder
    (the fairseq-class parser), its encoder on the BiLSTM kernels;
  * :mod:`stair_tpu_torch.seq2seq.transformer` — pre-norm encoder-decoder
    transformer;
  * :mod:`stair_tpu_torch.seq2seq.t5` — T5 (the Flan-T5 recipe);
  * :mod:`stair_tpu_torch.seq2seq.beam` — batched beam search over any;
  * :mod:`stair_tpu_torch.seq2seq.train` — train/predict CLI emitting the
    TSV format the merge path (``preprocess --func upgrade``) consumes;
  * :mod:`stair_tpu_torch.seq2seq.vocab`, :mod:`~.export` — copies.
"""
