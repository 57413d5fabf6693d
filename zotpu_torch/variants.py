"""Clinical/variant toolkit: HGVS-style probes, evidence, spike-in.

A copy of zotpu/variants.py (host-only numpy code).

Reference analog: zotmer's clinical-genomics command family (SURVEY.md
section 2a "HGVS/clinical tools": generate variant k-mer probes from HGVS
descriptions, find evidence for variants in raw reads, spike simulated
variant reads). The reference mount was empty, so the exact HGVS dialect
could not be verified; this module implements the standard genomic-HGVS
core -- substitution, deletion, insertion, duplication, delins, inversion --
against a
user-supplied reference FASTA, which covers the documented capability
(probe generation -> read evidence -> simulation) end to end.

Supported variant syntax (g. coordinates, 1-based, on a named reference
sequence):

    SEQ:g.123A>G            substitution
    SEQ:g.123_125del        deletion (also g.123del)
    SEQ:g.123_124insTTG     insertion between 123 and 124
    SEQ:g.123_125dup        duplication (also g.123dup)
    SEQ:g.123_125delinsGGC  deletion-insertion
    SEQ:g.123_125inv        inversion (span replaced by its reverse complement)

Transcript (c./n.) coordinates are supported when a transcript table is
given (refGene-style TSV, see ``load_transcripts``): ``TX1:c.76A>T``,
``TX1:c.-14G>C`` (5' UTR), ``TX1:c.*6del`` (3' UTR), ``TX1:c.88+2T>G``
(intronic, splice donor), ``TX1:n.42del`` (noncoding transcript). The c./n.
description is resolved to a genomic Variant through the transcript's exon
structure and strand (alleles reverse-complement onto '-'-strand genes), so
everything downstream -- probes, evidence, spike-in -- is coordinate-system
agnostic. Spans (``c.a_b``) whose endpoints are both PLAIN EXONIC positions
in different exons are rejected (the c. span skips the intron, so the
genomic edit is ambiguous); endpoints carrying intron offsets (``N+M`` /
``N-M``) resolve to exact genomic bases, so spans through a splice
boundary described that way (e.g. ``c.20_21+5del``) are accepted as the
exact genomic interval they name.

Probe model: the k-mers whose windows OVERLAP the edited bases -- k-1 bases
of flanking context on each side -- computed on the reference allele (ref
probes) and on the edited sequence (alt probes); alt probes that also occur
among the locus's ref probes are dropped (they carry no signal). Evidence =
per-probe counts in the sample's k-mer set (device kmerize; panels are tiny
so per-variant attribution happens on the host).
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np

from zotpu_torch import semantics as S
from zotpu_torch.reference_impl import golden as G

_VAR_RE = re.compile(
    r"^(?P<seq>[^:]+):g\.(?P<a>\d+)(?:_(?P<b>\d+))?"
    r"(?:(?P<sub>[ACGTacgt])>(?P<alt>[ACGTacgt])"
    r"|(?P<op>del|dup|ins|delins|inv)(?P<arg>[ACGTacgt]*))$")

_RC = str.maketrans("ACGT", "TGCA")


@dataclasses.dataclass(frozen=True)
class Variant:
    spec: str          # the original description (output key)
    seq_name: str
    start: int         # 0-based inclusive start of the affected ref span
    end: int           # 0-based exclusive end of the affected ref span
    ref: str           # replaced reference bases ("" for pure insertion)
    alt: str           # replacement bases ("" for pure deletion); None until
                       # resolve for ops derived from the ref span (dup, inv)
    op: str = ""       # which ref-span-derived op fills alt ("dup" | "inv")


def parse_variant(spec: str) -> Variant:
    """Parse one HGVS-style genomic variant description."""
    m = _VAR_RE.match(spec.strip())
    if not m:
        raise ValueError(
            f"cannot parse variant {spec!r} (expected SEQ:g.<pos><REF>><ALT>,"
            f" SEQ:g.<a>_<b>del|dup|inv|delins<SEQ>, or SEQ:g.<a>_<b>ins<SEQ>)")
    seq_name = m.group("seq")
    a = int(m.group("a"))
    b = int(m.group("b")) if m.group("b") else a
    if a < 1:
        # HGVS positions are 1-based; 0 would wrap to start=-1 and slice
        # from the END of the reference, silently garbling every probe
        raise ValueError(f"{spec!r}: positions are 1-based, got {a}")
    if b < a:
        raise ValueError(f"{spec!r}: end {b} before start {a}")
    if m.group("sub"):
        if m.group("b"):
            raise ValueError(f"{spec!r}: substitutions take one position")
        return Variant(spec, seq_name, a - 1, a, m.group("sub").upper(),
                       m.group("alt").upper())
    op = m.group("op")
    arg = (m.group("arg") or "").upper()
    if op == "ins":
        if not m.group("b") or b != a + 1:
            raise ValueError(
                f"{spec!r}: insertion positions must be adjacent (a_a+1)")
        if not arg:
            raise ValueError(f"{spec!r}: ins needs the inserted sequence")
        return Variant(spec, seq_name, a, a, "", arg)  # between a and a+1
    if op == "del":
        if arg:
            raise ValueError(f"{spec!r}: del takes no sequence argument")
        return Variant(spec, seq_name, a - 1, b, "", "")
    if op in ("dup", "inv"):
        if arg:
            raise ValueError(f"{spec!r}: {op} takes no sequence argument")
        return Variant(spec, seq_name, a - 1, b, "", None, op=op)  # alt at resolve
    if op == "delins":
        if not arg:
            raise ValueError(f"{spec!r}: delins needs the new sequence")
        return Variant(spec, seq_name, a - 1, b, "", arg)
    raise AssertionError(op)


# --- transcript (c./n.) coordinates -----------------------------------------
#
# Reference analog: zotmer's HGVS tooling resolved transcript-relative
# variant descriptions through refGene-style gene models (SURVEY.md
# section 2a "HGVS/clinical tools"; exact dialect unverifiable -- empty
# reference mount). The c./n. grammar implemented here is the standard
# clinical core: coding positions, 5'UTR (-N), 3'UTR (*N), and intronic
# offsets (N+M / N-M, e.g. splice-site variants).

_TVAR_RE = re.compile(
    r"^(?P<tx>[^:]+):(?P<sys>[cn])\.(?P<a>\*?-?\d+(?:[+-]\d+)?)"
    r"(?:_(?P<b>\*?-?\d+(?:[+-]\d+)?))?"
    r"(?:(?P<sub>[ACGTacgt])>(?P<alt>[ACGTacgt])"
    r"|(?P<op>del|dup|ins|delins|inv)(?P<arg>[ACGTacgt]*))$")

_CPOS_RE = re.compile(r"^(?P<star>\*)?(?P<base>-?\d+)(?:(?P<off>[+-]\d+))?$")


@dataclasses.dataclass(frozen=True)
class Transcript:
    """A spliced gene model on the reference (refGene-style)."""
    name: str
    seq_name: str
    strand: str                      # '+' or '-'
    exons: tuple                     # genomic (start, end), 0-based half-open,
                                     # ascending by genomic coordinate
    cds_start: int | None = None     # genomic 0-based half-open CDS bounds;
    cds_end: int | None = None       # None for noncoding (n.-only) models

    def spliced_len(self) -> int:
        return sum(e - s for s, e in self.exons)


def load_transcripts(path: str) -> dict[str, "Transcript"]:
    """Parse a refGene-style TSV into {name: Transcript}.

    Accepts UCSC refGene rows (with or without the leading ``bin`` column):
    name, chrom, strand, txStart, txEnd, cdsStart, cdsEnd, exonCount,
    exonStarts, exonEnds -- starts/ends are comma-separated 0-based genomic
    coordinates. A transcript with cdsStart == cdsEnd is noncoding (n. only).
    Lines starting with '#' are skipped.
    """
    out = {}
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            fields = line.split("\t") if "\t" in line else line.split()
            if len(fields) >= 11 and fields[0].lstrip("-").isdigit() \
                    and fields[3] in ("+", "-"):
                fields = fields[1:]          # UCSC ``bin`` column
            if len(fields) < 10:
                raise ValueError(f"{path}:{ln}: expected >=10 refGene-style "
                                 f"columns, got {len(fields)}")
            (name, chrom, strand, tx_s, tx_e, cds_s, cds_e, n_ex,
             ex_s, ex_e) = fields[:10]
            if strand not in ("+", "-"):
                # tuple, not the string "+-": an EMPTY strand field (double
                # tab) satisfies `'' in "+-"` and loads a transcript whose
                # coordinate math and allele flipping silently disagree
                raise ValueError(f"{path}:{ln}: bad strand {strand!r}")
            starts = [int(x) for x in ex_s.rstrip(",").split(",")]
            ends = [int(x) for x in ex_e.rstrip(",").split(",")]
            if len(starts) != len(ends) or len(starts) != int(n_ex):
                raise ValueError(f"{path}:{ln}: exonCount/exonStarts/exonEnds "
                                 f"disagree")
            exons = tuple(sorted(zip(starts, ends)))
            for (s0, e0), (s1, _) in zip(exons, exons[1:]):
                if e0 > s1:
                    raise ValueError(f"{path}:{ln}: overlapping exons")
            cds_s, cds_e = int(cds_s), int(cds_e)
            coding = cds_s < cds_e
            if name in out:
                # real refGene dumps repeat accessions at multiple loci; a
                # silent last-row-wins would resolve c. variants against the
                # wrong locus
                raise ValueError(
                    f"{path}:{ln}: duplicate transcript name {name!r} "
                    f"(first at {out[name].seq_name}); disambiguate the "
                    f"table "
                    f"(e.g. suffix the accession with its locus)")
            out[name] = Transcript(
                name, chrom, strand, exons,
                cds_s if coding else None, cds_e if coding else None)
    return out


def _spliced_index(tx: Transcript, gpos: int) -> int:
    """Transcript-order spliced index of an exonic genomic position."""
    t = 0
    for s, e in tx.exons:
        if s <= gpos < e:
            t += gpos - s
            break
        t += e - s
    else:
        raise ValueError(f"position {gpos} not exonic in {tx.name}")
    return t if tx.strand == "+" else tx.spliced_len() - 1 - t


def _genomic_of_spliced(tx: Transcript, t: int) -> int:
    """Genomic 0-based position of spliced index t (transcript order)."""
    if not 0 <= t < tx.spliced_len():
        raise ValueError(
            f"{tx.name}: transcript position {t + 1} outside the spliced "
            f"transcript (length {tx.spliced_len()})")
    walk = t if tx.strand == "+" else tx.spliced_len() - 1 - t
    for s, e in tx.exons:
        if walk < e - s:
            return s + walk
        walk -= e - s
    raise AssertionError


def _anchor_spliced(tx: Transcript, sys: str, star: bool, base: int,
                    spec: str) -> int:
    """Spliced index of a c./n. anchor (before any intron offset)."""
    if sys == "n":
        if star or base < 1:
            raise ValueError(f"{spec!r}: n. positions are plain 1-based "
                             f"transcript positions")
        return base - 1
    if tx.cds_start is None:
        raise ValueError(f"{spec!r}: {tx.name} is noncoding -- use n. "
                         f"coordinates")
    # spliced indices of the first and last CDS base
    if tx.strand == "+":
        cds_first = _spliced_index(tx, tx.cds_start)
        cds_last = _spliced_index(tx, tx.cds_end - 1)
    else:
        cds_first = _spliced_index(tx, tx.cds_end - 1)
        cds_last = _spliced_index(tx, tx.cds_start)
    if star:                         # *N: N bases past the stop codon
        if base < 1:
            raise ValueError(f"{spec!r}: *N positions start at *1")
        return cds_last + base
    if base >= 1:                    # coding
        return cds_first + base - 1
    if base <= -1:                   # 5' UTR
        return cds_first + base      # c.-1 is the base before the CDS
    raise ValueError(f"{spec!r}: c.0 is not a valid HGVS position")


def _resolve_tx_pos(tx: Transcript, pos: str, sys: str, spec: str
                    ) -> tuple[int, int | None]:
    """One c./n. position -> (genomic 0-based pos, exon_id | None).

    exon_id is the index of the containing exon for plain exonic anchors,
    None for intron-offset positions (used to reject intron-crossing spans).
    """
    m = _CPOS_RE.match(pos)
    if not m:
        raise ValueError(f"{spec!r}: cannot parse position {pos!r}")
    t = _anchor_spliced(tx, sys, bool(m.group("star")),
                        int(m.group("base")), spec)
    g = _genomic_of_spliced(tx, t)
    off = int(m.group("off")) if m.group("off") else 0
    if off == 0:
        exon_id = next(i for i, (s, e) in enumerate(tx.exons) if s <= g < e)
        return g, exon_id
    # intron offset: +M walks 3' of the anchor exon's end (transcript
    # direction), -M walks 5' of its start; validate the anchor sits on the
    # matching exon boundary, as HGVS requires.
    ei, exon = next((i, (s, e)) for i, (s, e) in enumerate(tx.exons)
                    if s <= g < e)
    sign = 1 if off > 0 else -1
    tx_sign = sign if tx.strand == "+" else -sign
    boundary = exon[1] - 1 if tx_sign > 0 else exon[0]
    if g != boundary:
        raise ValueError(
            f"{spec!r}: intron offset {off:+d} must anchor on the exon "
            f"boundary base (anchor is {abs(g - boundary)} bases inside "
            f"the exon)")
    g2 = g + tx_sign * abs(off)
    # the offset must land strictly inside the intron ADJACENT to the anchor
    # exon -- an offset longer than that intron is an invalid HGVS spec, and
    # silently accepting it would place probes at wrong genomic coordinates
    # (a different intron / past the transcript)
    if tx_sign > 0:
        if ei + 1 >= len(tx.exons):
            raise ValueError(f"{spec!r}: intron offset walks past the last "
                             f"exon (no intron 3' of the anchor)")
        ilo, ihi = exon[1], tx.exons[ei + 1][0]
    else:
        if ei == 0:
            raise ValueError(f"{spec!r}: intron offset walks past the first "
                             f"exon (no intron 5' of the anchor)")
        ilo, ihi = tx.exons[ei - 1][1], exon[0]
    if not ilo <= g2 < ihi:
        raise ValueError(
            f"{spec!r}: intron offset {off:+d} overshoots the adjacent "
            f"intron ({ihi - ilo} bases)")
    return g2, None


def parse_tx_variant(spec: str, transcripts: dict[str, "Transcript"]
                     ) -> Variant:
    """Parse a transcript-relative (c./n.) description into a genomic
    Variant (alleles mapped onto the reference strand)."""
    m = _TVAR_RE.match(spec.strip())
    if not m:
        raise ValueError(
            f"cannot parse variant {spec!r} (expected TX:c.<pos><REF>><ALT>, "
            f"TX:c.<a>_<b>del|dup|inv|delins<SEQ>, TX:c.<a>_<b>ins<SEQ>, "
            f"or the n. forms; positions may be -N, *N, or N+M/N-M)")
    tx_name = m.group("tx")
    if tx_name not in transcripts:
        raise ValueError(f"{spec!r}: transcript {tx_name!r} not in the "
                         f"transcript table (has "
                         f"{sorted(transcripts)[:5]}...)")
    tx = transcripts[tx_name]
    sys = m.group("sys")
    ga, exon_a = _resolve_tx_pos(tx, m.group("a"), sys, spec)
    if m.group("b"):
        gb, exon_b = _resolve_tx_pos(tx, m.group("b"), sys, spec)
        if exon_a is not None and exon_b is not None and exon_a != exon_b:
            raise ValueError(
                f"{spec!r}: span crosses an intron (exonic endpoints in "
                f"different exons); describe the genomic interval with "
                f"intron-offset endpoints or a g. variant instead")
        if (gb - ga) * (1 if tx.strand == "+" else -1) < 0:
            raise ValueError(f"{spec!r}: end position before start in "
                             f"transcript order")
    else:
        gb = ga
    glo, ghi = min(ga, gb), max(ga, gb)            # genomic 0-based, inclusive
    minus = tx.strand == "-"

    def flip(s: str) -> str:
        return s.translate(_RC)[::-1] if minus else s

    if m.group("sub"):
        if m.group("b"):
            raise ValueError(f"{spec!r}: substitutions take one position")
        return Variant(spec, tx.seq_name, glo, glo + 1,
                       flip(m.group("sub").upper()),
                       flip(m.group("alt").upper()))
    op = m.group("op")
    arg = (m.group("arg") or "").upper()
    if op == "ins":
        if not m.group("b") or ghi != glo + 1:
            raise ValueError(f"{spec!r}: insertion positions must be "
                             f"adjacent (genomically contiguous a_a+1)")
        if not arg:
            raise ValueError(f"{spec!r}: ins needs the inserted sequence")
        return Variant(spec, tx.seq_name, glo + 1, glo + 1, "", flip(arg))
    if op == "del":
        if arg:
            raise ValueError(f"{spec!r}: del takes no sequence argument")
        return Variant(spec, tx.seq_name, glo, ghi + 1, "", "")
    if op in ("dup", "inv"):
        if arg:
            raise ValueError(f"{spec!r}: {op} takes no sequence argument")
        return Variant(spec, tx.seq_name, glo, ghi + 1, "", None, op=op)
    if op == "delins":
        if not arg:
            raise ValueError(f"{spec!r}: delins needs the new sequence")
        return Variant(spec, tx.seq_name, glo, ghi + 1, "", flip(arg))
    raise AssertionError(op)


def parse_any_variant(spec: str,
                      transcripts: dict[str, "Transcript"] | None = None
                      ) -> Variant:
    """Dispatch between genomic (SEQ:g.) and transcript (TX:c./n.) specs."""
    if re.match(r"^[^:]+:[cn]\.", spec.strip()):
        if not transcripts:
            raise ValueError(f"{spec!r}: c./n. coordinates need a "
                             f"transcript table (--transcripts)")
        return parse_tx_variant(spec, transcripts)
    return parse_variant(spec)


def resolve_variant(v: Variant, ref_seqs: dict[str, str]) -> Variant:
    """Validate against the reference and fill ref/alt alleles."""
    if v.seq_name not in ref_seqs:
        raise ValueError(f"{v.spec!r}: sequence {v.seq_name!r} not in the "
                         f"reference (has {sorted(ref_seqs)[:5]}...)")
    seq = ref_seqs[v.seq_name].upper()
    if v.end > len(seq):
        raise ValueError(f"{v.spec!r}: position {v.end} beyond sequence "
                         f"length {len(seq)}")
    span = seq[v.start:v.end]
    if v.ref and span != v.ref:
        raise ValueError(f"{v.spec!r}: reference has {span!r} at that "
                         f"position, not {v.ref!r}")
    alt = v.alt
    if alt is None:  # derived from the ref span
        alt = span + span if v.op == "dup" else span.translate(_RC)[::-1]
    return dataclasses.replace(v, ref=span, alt=alt)


def apply_variant(seq: str, v: Variant) -> str:
    """The full edited sequence (v must be resolved)."""
    return seq[:v.start] + v.alt + seq[v.end:]


def probe_kmers(v: Variant, ref_seqs: dict[str, str], k: int
                ) -> tuple[np.ndarray, np.ndarray]:
    """(ref_probes, alt_probes): sorted unique canonical k-mers whose windows
    overlap the edited span, on each allele. Alt probes also present among
    the locus's ref probes are dropped (no discriminating power)."""
    seq = ref_seqs[v.seq_name].upper()
    lo = max(v.start - (k - 1), 0)
    ref_hi = min(v.end + (k - 1), len(seq))
    ref_ctx = seq[lo:ref_hi]
    alt_seq = apply_variant(seq, v)
    alt_hi = min(v.start + len(v.alt) + (k - 1), len(alt_seq))
    alt_ctx = alt_seq[lo:alt_hi]
    ref_probes = np.unique(G.kmerize_seq(k, ref_ctx))
    alt_probes = np.unique(G.kmerize_seq(k, alt_ctx))
    alt_probes = np.setdiff1d(alt_probes, ref_probes, assume_unique=True)
    return ref_probes, alt_probes


def load_reference(path: str) -> dict[str, str]:
    from zotpu_torch.io import fastq
    with fastq.open_file(path, "rb") as f:
        return {name: seq for name, seq in fastq.read_fasta(f)}


def build_panel(specs: list[str], ref_path: str, k: int,
                transcripts_path: str | None = None):
    """All variants' probes + the per-variant attribution metadata.

    Returns (keys, meta): keys = sorted unique union of every probe; meta
    maps each variant spec to its ref/alt probe lists (hex) for host-side
    attribution in `evidence`. With ``transcripts_path``, specs may use
    transcript (c./n.) coordinates.
    """
    S.check_k(k)
    ref_seqs = load_reference(ref_path)
    transcripts = (load_transcripts(transcripts_path)
                   if transcripts_path else None)
    meta = []
    all_keys = []
    for spec in specs:
        v = resolve_variant(parse_any_variant(spec, transcripts), ref_seqs)
        ref_p, alt_p = probe_kmers(v, ref_seqs, k)
        if len(alt_p) == 0:
            raise ValueError(
                f"{spec!r}: no discriminating alt probes at k={k} (edit is "
                f"invisible -- try a larger k)")
        meta.append({
            "spec": spec,
            "ref_probes": [f"{x:016x}" for x in ref_p],
            "alt_probes": [f"{x:016x}" for x in alt_p],
        })
        all_keys.append(ref_p)
        all_keys.append(alt_p)
    keys = np.unique(np.concatenate(all_keys)) if all_keys else np.empty(
        0, np.uint64)
    return keys, {"variants": meta, "k": k, "reference": ref_path}


def evidence_from_counts(meta: dict, keys: np.ndarray, counts: np.ndarray
                         ) -> list[dict]:
    """Per-variant support from a sample's sorted k-mer set (host side;
    probe panels are tiny)."""
    out = []
    for m in meta["variants"]:
        rows = {}
        for allele in ("ref", "alt"):
            probes = np.asarray([int(x, 16) for x in m[f"{allele}_probes"]],
                                np.uint64)
            if len(keys) == 0:
                ok = np.zeros(len(probes), bool)
                c = np.zeros(len(probes), np.int64)
            else:
                idx = np.searchsorted(keys, probes)
                ok = (idx < len(keys)) & (keys[np.minimum(idx, len(keys) - 1)]
                                          == probes)
                c = np.where(ok, counts[np.minimum(idx, len(counts) - 1)], 0)
            rows[allele] = {
                "probes": int(len(probes)),
                "probes_hit": int(ok.sum()),
                "support": int(np.median(c[ok])) if ok.any() else 0,
                "total": int(c.sum()),
            }
        a, r = rows["alt"]["support"], rows["ref"]["support"]
        out.append({
            "variant": m["spec"],
            "ref": rows["ref"], "alt": rows["alt"],
            "vaf_estimate": a / (a + r) if (a + r) else 0.0,
        })
    return out


def spike_reads(ref_path: str, specs: list[str], out_path: str, *,
                coverage: float = 30.0, vaf: float = 0.5,
                read_len: int = 100, error_rate: float = 0.0,
                seed: int = 0, transcripts_path: str | None = None) -> dict:
    """Simulate reads from the reference with variants applied on a fraction
    ``vaf`` of them -- the test harness for the evidence pipeline."""
    rng = np.random.default_rng(seed)
    ref_seqs = load_reference(ref_path)
    transcripts = (load_transcripts(transcripts_path)
                   if transcripts_path else None)
    variants = [resolve_variant(parse_any_variant(s, transcripts), ref_seqs)
                for s in specs]
    alt_seqs = dict(ref_seqs)
    for v in variants:
        alt_seqs[v.seq_name] = apply_variant(alt_seqs[v.seq_name], v)
        # NOTE: multiple variants on one sequence apply left-to-right on the
        # progressively edited sequence; coordinates are per the ORIGINAL
        # reference, so callers should keep per-sequence variants disjoint
        # and ordered (sufficient for test spiking).
    lut = np.frombuffer(b"ACGT", np.uint8)
    n_written = 0
    from zotpu_torch.io.fastq import open_file
    with open_file(out_path, "wb") as f:
        for name, seq in ref_seqs.items():
            n_reads = max(int(len(seq) * coverage / read_len), 1)
            for i in range(n_reads):
                use_alt = rng.random() < vaf
                src = alt_seqs[name] if use_alt else seq
                if len(src) < read_len:
                    continue
                off = int(rng.integers(0, len(src) - read_len + 1))
                read = np.frombuffer(src[off:off + read_len].encode(),
                                     np.uint8).copy()
                if error_rate > 0:
                    errs = np.where(rng.random(read_len) < error_rate)[0]
                    read[errs] = lut[rng.integers(0, 4, len(errs))]
                rid = f"@sim{n_written} {name}:{off} {'alt' if use_alt else 'ref'}"
                f.write((rid + "\n").encode())
                f.write(read.tobytes() + b"\n+\n" + b"I" * read_len + b"\n")
                n_written += 1
    return {"reads": n_written, "vaf": vaf, "coverage": coverage}
