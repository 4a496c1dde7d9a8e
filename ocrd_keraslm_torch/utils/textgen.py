"""Deterministic German prose generator for quality tests and benchmarks.

The port's own copy of ``ocrd_keraslm_tpu/utils/textgen.py`` (same
grammar, lexicon and seeding, so ``generate(n, seed)`` gives the same
string in both packages).  The reference pins its quality numbers on
genuine German text (DTA full text, val char-ppl 2.51, the reference's
README; workspace ppl bounds in its ``test/test_wrapper.py``).  No
German corpus ships with this package, so this module *synthesizes*
one: a weighted context-free grammar over a real German lexicon with
full morphology — article/adjective/noun agreement across four cases,
three genders and two numbers, verb conjugation
(present/preterite/perfect/modal), V2 and verb-final clause order,
relative and subordinate clauses, genitive attributes, dates, numbers
and quoted speech.  Character-level statistics (letter/bigram
frequencies, umlaut/ß rates, capitalisation of nouns, punctuation
rhythm) closely track real German prose, which is what a *char-level*
LM sees.

Everything is seeded: ``generate(seed=...)`` is reproducible across
runs and platforms (pure ``random.Random``, no hash randomisation).

CLI: ``python -m ocrd_keraslm_torch.utils.textgen --chars 3000000 --out DIR``
writes ``author_title_year.txt`` files (the reference's training-file
naming scheme) totalling ~chars bytes.
"""

from __future__ import annotations

import random
import unicodedata
from typing import List, Tuple

# --------------------------------------------------------------------
# Lexicon.  (lemma tables; common contemporary German vocabulary)
# --------------------------------------------------------------------

# nouns: (lemma, gender m/f/n, plural)
NOUNS = [
    ('Zeit', 'f', 'Zeiten'), ('Jahr', 'n', 'Jahre'), ('Mensch', 'm', 'Menschen'),
    ('Tag', 'm', 'Tage'), ('Frau', 'f', 'Frauen'), ('Mann', 'm', 'Männer'),
    ('Kind', 'n', 'Kinder'), ('Welt', 'f', 'Welten'), ('Leben', 'n', 'Leben'),
    ('Hand', 'f', 'Hände'), ('Stadt', 'f', 'Städte'), ('Herr', 'm', 'Herren'),
    ('Vater', 'm', 'Väter'), ('Mutter', 'f', 'Mütter'), ('Auge', 'n', 'Augen'),
    ('Wort', 'n', 'Worte'), ('Haus', 'n', 'Häuser'), ('Weg', 'm', 'Wege'),
    ('Frage', 'f', 'Fragen'), ('Land', 'n', 'Länder'), ('Teil', 'm', 'Teile'),
    ('Recht', 'n', 'Rechte'), ('Ende', 'n', 'Enden'), ('Nacht', 'f', 'Nächte'),
    ('Kopf', 'm', 'Köpfe'), ('Seite', 'f', 'Seiten'), ('Geschichte', 'f', 'Geschichten'),
    ('Kraft', 'f', 'Kräfte'), ('Licht', 'n', 'Lichter'), ('Stimme', 'f', 'Stimmen'),
    ('Freund', 'm', 'Freunde'), ('Gedanke', 'm', 'Gedanken'), ('Natur', 'f', 'Naturen'),
    ('Grund', 'm', 'Gründe'), ('Arbeit', 'f', 'Arbeiten'), ('Name', 'm', 'Namen'),
    ('Buch', 'n', 'Bücher'), ('Geist', 'm', 'Geister'), ('Herz', 'n', 'Herzen'),
    ('Raum', 'm', 'Räume'), ('Ordnung', 'f', 'Ordnungen'), ('Gesetz', 'n', 'Gesetze'),
    ('Sprache', 'f', 'Sprachen'), ('Bild', 'n', 'Bilder'), ('Tür', 'f', 'Türen'),
    ('Wasser', 'n', 'Wasser'), ('Erde', 'f', 'Erden'), ('Himmel', 'm', 'Himmel'),
    ('Sonne', 'f', 'Sonnen'), ('Morgen', 'm', 'Morgen'), ('Abend', 'm', 'Abende'),
    ('Sache', 'f', 'Sachen'), ('Art', 'f', 'Arten'), ('Form', 'f', 'Formen'),
    ('Begriff', 'm', 'Begriffe'), ('Wissen', 'n', 'Wissen'), ('Wahrheit', 'f', 'Wahrheiten'),
    ('Freiheit', 'f', 'Freiheiten'), ('Pflicht', 'f', 'Pflichten'), ('Wille', 'm', 'Willen'),
    ('Vernunft', 'f', 'Vernünfte'), ('Seele', 'f', 'Seelen'), ('Körper', 'm', 'Körper'),
    ('Wesen', 'n', 'Wesen'), ('Ursache', 'f', 'Ursachen'), ('Wirkung', 'f', 'Wirkungen'),
    ('Erfahrung', 'f', 'Erfahrungen'), ('Erkenntnis', 'f', 'Erkenntnisse'),
    ('Bedingung', 'f', 'Bedingungen'), ('Möglichkeit', 'f', 'Möglichkeiten'),
    ('Wirklichkeit', 'f', 'Wirklichkeiten'), ('Gegenstand', 'm', 'Gegenstände'),
    ('Verhältnis', 'n', 'Verhältnisse'), ('Gesellschaft', 'f', 'Gesellschaften'),
    ('Staat', 'm', 'Staaten'), ('Volk', 'n', 'Völker'), ('Krieg', 'm', 'Kriege'),
    ('Friede', 'm', 'Frieden'), ('Macht', 'f', 'Mächte'), ('Liebe', 'f', 'Lieben'),
    ('Hoffnung', 'f', 'Hoffnungen'), ('Angst', 'f', 'Ängste'), ('Glück', 'n', 'Glücke'),
    ('Schmerz', 'm', 'Schmerzen'), ('Traum', 'm', 'Träume'), ('Wald', 'm', 'Wälder'),
    ('Berg', 'm', 'Berge'), ('Fluss', 'm', 'Flüsse'), ('Meer', 'n', 'Meere'),
    ('Wind', 'm', 'Winde'), ('Stein', 'm', 'Steine'), ('Baum', 'm', 'Bäume'),
    ('Blume', 'f', 'Blumen'), ('Vogel', 'm', 'Vögel'), ('Pferd', 'n', 'Pferde'),
    ('Garten', 'm', 'Gärten'), ('Straße', 'f', 'Straßen'), ('Platz', 'm', 'Plätze'),
    ('Kirche', 'f', 'Kirchen'), ('Schule', 'f', 'Schulen'), ('Meister', 'm', 'Meister'),
    ('Schüler', 'm', 'Schüler'), ('Lehre', 'f', 'Lehren'), ('Kunst', 'f', 'Künste'),
    ('Werk', 'n', 'Werke'), ('Lied', 'n', 'Lieder'), ('Spiel', 'n', 'Spiele'),
    ('Brief', 'm', 'Briefe'), ('Papier', 'n', 'Papiere'), ('Tisch', 'm', 'Tische'),
    ('Fenster', 'n', 'Fenster'), ('Zimmer', 'n', 'Zimmer'), ('Feuer', 'n', 'Feuer'),
    ('Brot', 'n', 'Brote'), ('Wein', 'm', 'Weine'), ('Geld', 'n', 'Gelder'),
    ('Zahl', 'f', 'Zahlen'), ('Maß', 'n', 'Maße'), ('Ziel', 'n', 'Ziele'),
    ('Anfang', 'm', 'Anfänge'), ('Mitte', 'f', 'Mitten'), ('Folge', 'f', 'Folgen'),
    ('Zweck', 'm', 'Zwecke'), ('Sinn', 'm', 'Sinne'), ('Wert', 'm', 'Werte'),
    ('Urteil', 'n', 'Urteile'), ('Beispiel', 'n', 'Beispiele'), ('Regel', 'f', 'Regeln'),
    ('Fall', 'm', 'Fälle'), ('Punkt', 'm', 'Punkte'), ('Linie', 'f', 'Linien'),
    ('Fläche', 'f', 'Flächen'), ('Bewegung', 'f', 'Bewegungen'), ('Ruhe', 'f', 'Ruhen'),
    ('Stunde', 'f', 'Stunden'), ('Woche', 'f', 'Wochen'), ('Monat', 'm', 'Monate'),
    ('Winter', 'm', 'Winter'), ('Sommer', 'm', 'Sommer'), ('Frühling', 'm', 'Frühlinge'),
    ('Herbst', 'm', 'Herbste'), ('Regen', 'm', 'Regen'), ('Schnee', 'm', 'Schnees'),
    ('Gast', 'm', 'Gäste'), ('Reise', 'f', 'Reisen'), ('Dorf', 'n', 'Dörfer'),
    ('Turm', 'm', 'Türme'), ('Tor', 'n', 'Tore'), ('Brücke', 'f', 'Brücken'),
    ('Schiff', 'n', 'Schiffe'), ('Insel', 'f', 'Inseln'), ('Küste', 'f', 'Küsten'),
    ('Gefahr', 'f', 'Gefahren'), ('Mut', 'm', 'Mute'), ('Ehre', 'f', 'Ehren'),
    ('Schuld', 'f', 'Schulden'), ('Strafe', 'f', 'Strafen'), ('Lohn', 'm', 'Löhne'),
    ('Dienst', 'm', 'Dienste'), ('Amt', 'n', 'Ämter'), ('Rat', 'm', 'Räte'),
    ('Fürst', 'm', 'Fürsten'), ('König', 'm', 'Könige'), ('Reich', 'n', 'Reiche'),
    ('Bürger', 'm', 'Bürger'), ('Bauer', 'm', 'Bauern'), ('Acker', 'm', 'Äcker'),
    ('Ernte', 'f', 'Ernten'), ('Mühle', 'f', 'Mühlen'), ('Handel', 'm', 'Handel'),
    ('Ware', 'f', 'Waren'), ('Markt', 'm', 'Märkte'), ('Preis', 'm', 'Preise'),
]

# verbs: (infinitive, pres3sg, pret3sg, participle, aux, transitive)
VERBS = [
    ('sehen', 'sieht', 'sah', 'gesehen', 'haben', True),
    ('geben', 'gibt', 'gab', 'gegeben', 'haben', True),
    ('finden', 'findet', 'fand', 'gefunden', 'haben', True),
    ('nehmen', 'nimmt', 'nahm', 'genommen', 'haben', True),
    ('bringen', 'bringt', 'brachte', 'gebracht', 'haben', True),
    ('halten', 'hält', 'hielt', 'gehalten', 'haben', True),
    ('tragen', 'trägt', 'trug', 'getragen', 'haben', True),
    ('rufen', 'ruft', 'rief', 'gerufen', 'haben', True),
    ('lesen', 'liest', 'las', 'gelesen', 'haben', True),
    ('schreiben', 'schreibt', 'schrieb', 'geschrieben', 'haben', True),
    ('hören', 'hört', 'hörte', 'gehört', 'haben', True),
    ('lieben', 'liebt', 'liebte', 'geliebt', 'haben', True),
    ('suchen', 'sucht', 'suchte', 'gesucht', 'haben', True),
    ('fragen', 'fragt', 'fragte', 'gefragt', 'haben', True),
    ('kennen', 'kennt', 'kannte', 'gekannt', 'haben', True),
    ('verstehen', 'versteht', 'verstand', 'verstanden', 'haben', True),
    ('erkennen', 'erkennt', 'erkannte', 'erkannt', 'haben', True),
    ('betrachten', 'betrachtet', 'betrachtete', 'betrachtet', 'haben', True),
    ('erreichen', 'erreicht', 'erreichte', 'erreicht', 'haben', True),
    ('verlieren', 'verliert', 'verlor', 'verloren', 'haben', True),
    ('gewinnen', 'gewinnt', 'gewann', 'gewonnen', 'haben', True),
    ('bauen', 'baut', 'baute', 'gebaut', 'haben', True),
    ('öffnen', 'öffnet', 'öffnete', 'geöffnet', 'haben', True),
    ('schließen', 'schließt', 'schloss', 'geschlossen', 'haben', True),
    ('zeigen', 'zeigt', 'zeigte', 'gezeigt', 'haben', True),
    ('erklären', 'erklärt', 'erklärte', 'erklärt', 'haben', True),
    ('bestimmen', 'bestimmt', 'bestimmte', 'bestimmt', 'haben', True),
    ('verändern', 'verändert', 'veränderte', 'verändert', 'haben', True),
    ('bewahren', 'bewahrt', 'bewahrte', 'bewahrt', 'haben', True),
    ('beginnen', 'beginnt', 'begann', 'begonnen', 'haben', True),
    ('gehen', 'geht', 'ging', 'gegangen', 'sein', False),
    ('kommen', 'kommt', 'kam', 'gekommen', 'sein', False),
    ('fahren', 'fährt', 'fuhr', 'gefahren', 'sein', False),
    ('laufen', 'läuft', 'lief', 'gelaufen', 'sein', False),
    ('fallen', 'fällt', 'fiel', 'gefallen', 'sein', False),
    ('steigen', 'steigt', 'stieg', 'gestiegen', 'sein', False),
    ('bleiben', 'bleibt', 'blieb', 'geblieben', 'sein', False),
    ('wachsen', 'wächst', 'wuchs', 'gewachsen', 'sein', False),
    ('entstehen', 'entsteht', 'entstand', 'entstanden', 'sein', False),
    ('erscheinen', 'erscheint', 'erschien', 'erschienen', 'sein', False),
    ('verschwinden', 'verschwindet', 'verschwand', 'verschwunden', 'sein', False),
    ('sprechen', 'spricht', 'sprach', 'gesprochen', 'haben', False),
    ('denken', 'denkt', 'dachte', 'gedacht', 'haben', False),
    ('leben', 'lebt', 'lebte', 'gelebt', 'haben', False),
    ('arbeiten', 'arbeitet', 'arbeitete', 'gearbeitet', 'haben', False),
    ('warten', 'wartet', 'wartete', 'gewartet', 'haben', False),
    ('schlafen', 'schläft', 'schlief', 'geschlafen', 'haben', False),
    ('lachen', 'lacht', 'lachte', 'gelacht', 'haben', False),
    ('weinen', 'weint', 'weinte', 'geweint', 'haben', False),
    ('schweigen', 'schweigt', 'schwieg', 'geschwiegen', 'haben', False),
    ('stehen', 'steht', 'stand', 'gestanden', 'haben', False),
    ('sitzen', 'sitzt', 'saß', 'gesessen', 'haben', False),
    ('liegen', 'liegt', 'lag', 'gelegen', 'haben', False),
    ('wirken', 'wirkt', 'wirkte', 'gewirkt', 'haben', False),
    ('scheinen', 'scheint', 'schien', 'geschienen', 'haben', False),
    ('leuchten', 'leuchtet', 'leuchtete', 'geleuchtet', 'haben', False),
    ('klingen', 'klingt', 'klang', 'geklungen', 'haben', False),
]

# adjectives (base forms; endings added by declension)
ADJECTIVES = [
    'alt', 'jung', 'groß', 'klein', 'gut', 'schön', 'lang', 'kurz', 'hoch',
    'tief', 'weit', 'nah', 'hell', 'dunkel', 'warm', 'kalt', 'still', 'laut',
    'schwer', 'leicht', 'stark', 'schwach', 'reich', 'arm', 'frei', 'wahr',
    'klar', 'rein', 'ganz', 'halb', 'voll', 'leer', 'neu', 'fremd', 'eigen',
    'einfach', 'schwierig', 'wichtig', 'möglich', 'wirklich', 'notwendig',
    'natürlich', 'menschlich', 'göttlich', 'ewig', 'endlich', 'innere',
    'äußere', 'allgemein', 'besondere', 'gewiss', 'bestimmt', 'deutlich',
    'ruhig', 'heftig', 'sanft', 'edel', 'tapfer', 'weise', 'klug', 'treu',
]

ADVERBS = [
    'heute', 'gestern', 'morgen', 'bald', 'oft', 'selten', 'immer', 'niemals',
    'zuerst', 'zuletzt', 'endlich', 'plötzlich', 'langsam', 'schnell',
    'gewiss', 'vielleicht', 'wohl', 'kaum', 'fast', 'ganz', 'sehr', 'hier',
    'dort', 'überall', 'daher', 'darum', 'dennoch', 'jedoch', 'indessen',
    'gleichwohl', 'freilich', 'übrigens', 'unterdessen', 'alsbald',
]

# prepositions: (word, case it governs)
PREPS_DAT = ['mit', 'nach', 'bei', 'von', 'zu', 'aus', 'unter', 'über',
             'vor', 'hinter', 'neben', 'in', 'an', 'auf']
PREPS_ACC = ['durch', 'für', 'gegen', 'ohne', 'um']

SUBORD = ['dass', 'weil', 'obwohl', 'wenn', 'als', 'da', 'indem', 'nachdem',
          'bevor', 'während', 'sobald', 'damit']
COORD = ['und', 'aber', 'denn', 'doch', 'oder']

MODALS = [  # (pres3sg, pret3sg, pres3pl, pret3pl)
    ('kann', 'konnte', 'können', 'konnten'),
    ('muss', 'musste', 'müssen', 'mussten'),
    ('will', 'wollte', 'wollen', 'wollten'),
    ('soll', 'sollte', 'sollen', 'sollten'),
    ('darf', 'durfte', 'dürfen', 'durften'),
    ('mag', 'mochte', 'mögen', 'mochten'),
]

NAMES = ['Johann', 'Friedrich', 'Wilhelm', 'Heinrich', 'Karl', 'Ludwig',
         'Anna', 'Maria', 'Charlotte', 'Sophie', 'Dorothea', 'Luise',
         'Georg', 'Franz', 'Otto', 'Eduard', 'Clara', 'Helene']

CITIES = ['Berlin', 'Weimar', 'Leipzig', 'Dresden', 'Jena', 'Göttingen',
          'Heidelberg', 'Königsberg', 'Frankfurt', 'Hamburg']

# definite articles [case][gender]; plural key 'p'
DEF = {
    'nom': {'m': 'der', 'f': 'die', 'n': 'das', 'p': 'die'},
    'acc': {'m': 'den', 'f': 'die', 'n': 'das', 'p': 'die'},
    'dat': {'m': 'dem', 'f': 'der', 'n': 'dem', 'p': 'den'},
    'gen': {'m': 'des', 'f': 'der', 'n': 'des', 'p': 'der'},
}
INDEF = {
    'nom': {'m': 'ein', 'f': 'eine', 'n': 'ein'},
    'acc': {'m': 'einen', 'f': 'eine', 'n': 'ein'},
    'dat': {'m': 'einem', 'f': 'einer', 'n': 'einem'},
    'gen': {'m': 'eines', 'f': 'einer', 'n': 'eines'},
}
# adjective endings: weak (after def.), mixed (after indef.)
WEAK = {
    'nom': {'m': 'e', 'f': 'e', 'n': 'e', 'p': 'en'},
    'acc': {'m': 'en', 'f': 'e', 'n': 'e', 'p': 'en'},
    'dat': {'m': 'en', 'f': 'en', 'n': 'en', 'p': 'en'},
    'gen': {'m': 'en', 'f': 'en', 'n': 'en', 'p': 'en'},
}
MIXED = {
    'nom': {'m': 'er', 'f': 'e', 'n': 'es'},
    'acc': {'m': 'en', 'f': 'e', 'n': 'es'},
    'dat': {'m': 'en', 'f': 'en', 'n': 'en'},
    'gen': {'m': 'en', 'f': 'en', 'n': 'en'},
}

PRONOUNS = {  # [person-key] -> (nom, 3sg?) used for subject variety
    'er': ('er', True), 'sie': ('sie', True), 'es': ('es', True),
    'man': ('man', True), 'wir': ('wir', False), 'sie_pl': ('sie', False),
}


def _adj(base: str, ending: str) -> str:
    # 'dunkel' -> 'dunkl-', 'hoch' -> 'hoh-', 'innere/äußere/besondere' drop -e
    stem = base
    if base == 'hoch':
        stem = 'hoh'
    elif base.endswith('el'):
        stem = base[:-2] + 'l'
    elif base.endswith('e'):
        stem = base[:-1]
    return stem + ending


def _gen_noun(lemma: str, gender: str) -> str:
    """Genitive singular form of a masculine/neuter noun."""
    if gender in 'mn':
        # weak masculine nouns take -(e)n
        if lemma in ('Mensch', 'Herr', 'Fürst', 'Bauer', 'Gedanke', 'Name',
                     'Wille', 'Friede', 'Herz'):
            return lemma + ('ns' if lemma in ('Gedanke', 'Name', 'Wille',
                                              'Friede') else
                            'ens' if lemma == 'Herz' else
                            'n' if lemma == 'Bauer' else 'en')
        if lemma[-1] in 'sßxz' or lemma.endswith('nis'):
            return lemma + ('ses' if lemma.endswith('nis') else 'es')
        if lemma[-1] in 'aeiouy' or lemma.endswith(('el', 'er', 'en')):
            return lemma + 's'
        return lemma + ('es' if len(lemma) <= 5 else 's')
    return lemma  # f: unchanged


def _dat_pl(plural: str) -> str:
    if plural.endswith(('n', 's')):
        return plural
    return plural + 'n'


class _Gen:
    """Grammar-driven sentence sampler over a seeded RNG."""

    def __init__(self, rng: random.Random):
        self.r = rng

    def np(self, case: str, allow_plural=True, allow_name=True) -> Tuple[str, bool]:
        """A noun phrase in the given case. Returns (text, is_plural_or_3pl)."""
        r = self.r
        if allow_name and r.random() < 0.06:
            name = r.choice(NAMES)
            if case == 'gen':
                return name + 's', False
            return name, False
        lemma, gender, plural = r.choice(NOUNS)
        use_pl = allow_plural and r.random() < 0.22
        use_adj = r.random() < 0.38
        gen_attr = ''
        if r.random() < 0.10:
            # genitive attribute: "die Kraft der Natur"
            gl, gg, gp = r.choice(NOUNS)
            if r.random() < 0.2:
                gen_attr = ' ' + DEF['gen']['p'] + ' ' + gp
            else:
                gen_attr = ' ' + DEF['gen'][gg] + ' ' + _gen_noun(gl, gg)
        if use_pl:
            noun = plural
            if case == 'dat':
                noun = _dat_pl(plural)
            if r.random() < 0.35:  # bare plural
                if use_adj:
                    # strong plural endings: nom/acc -e, dat -en, gen -er
                    e = {'nom': 'e', 'acc': 'e', 'dat': 'en', 'gen': 'er'}[case]
                    return _adj(r.choice(ADJECTIVES), e) + ' ' + noun + gen_attr, True
                return noun + gen_attr, True
            det = DEF[case]['p']
            if use_adj:
                return det + ' ' + _adj(r.choice(ADJECTIVES), WEAK[case]['p']) \
                    + ' ' + noun + gen_attr, True
            return det + ' ' + noun + gen_attr, True
        noun = lemma
        if case == 'gen':
            noun = _gen_noun(lemma, gender)
        # weak masculines decline in acc/dat too
        if gender == 'm' and case in ('acc', 'dat') and lemma in (
                'Mensch', 'Herr', 'Fürst', 'Bauer', 'Gedanke', 'Name',
                'Wille', 'Friede'):
            noun = lemma + ('n' if lemma in ('Gedanke', 'Name', 'Wille',
                                             'Friede', 'Bauer', 'Herr') else 'en')
        if r.random() < 0.65:
            det = DEF[case][gender]
            if use_adj:
                return det + ' ' + _adj(r.choice(ADJECTIVES),
                                        WEAK[case][gender]) + ' ' + noun + gen_attr, False
            return det + ' ' + noun + gen_attr, False
        det = INDEF[case][gender]
        if use_adj:
            return det + ' ' + _adj(r.choice(ADJECTIVES),
                                    MIXED[case][gender]) + ' ' + noun + gen_attr, False
        return det + ' ' + noun + gen_attr, False

    def pp(self) -> str:
        r = self.r
        if r.random() < 0.7:
            p = r.choice(PREPS_DAT)
            npx, _ = self.np('dat', allow_name=False)
            # contractions
            for (full, short) in (('in dem ', 'im '), ('an dem ', 'am '),
                                  ('zu dem ', 'zum '), ('zu der ', 'zur '),
                                  ('von dem ', 'vom '), ('bei dem ', 'beim ')):
                if (p + ' ' + npx).startswith(full):
                    return short + (p + ' ' + npx)[len(full):]
            return p + ' ' + npx
        p = r.choice(PREPS_ACC)
        npx, _ = self.np('acc', allow_name=False)
        return p + ' ' + npx

    def subject(self) -> Tuple[str, bool]:
        r = self.r
        if r.random() < 0.18:
            key = r.choice(list(PRONOUNS))
            word, sg = PRONOUNS[key]
            return word, not sg
        return self.np('nom')

    def verb_forms(self, plural: bool, past: bool):
        inf, p3s, pret, part, aux, trans = self.r.choice(VERBS)
        if past:
            v = pret if not plural else (
                pret + 'n' if pret.endswith('e') else pret + 'en')
        else:
            v = p3s if not plural else inf
        return v, inf, part, aux, trans

    def clause_main(self, past: bool) -> str:
        """A main clause (no final punctuation)."""
        r = self.r
        subj, plural = self.subject()
        shape = r.random()
        if shape < 0.12:  # modal: S kann O INF
            m = r.choice(MODALS)
            mv = m[1 if past else 0] if not plural else m[3 if past else 2]
            _, inf, _, _, trans = self.verb_forms(plural, past)
            obj = self.np('acc')[0] if trans else self.pp()
            return f'{subj} {mv} {obj} {inf}'
        if shape < 0.24:  # perfect: S hat O PART
            _, _, part, aux, trans = self.verb_forms(plural, False)
            av = ('haben' if plural else 'hat') if aux == 'haben' else \
                 ('sind' if plural else 'ist')
            mid = self.np('acc')[0] if trans else self.pp()
            return f'{subj} {av} {mid} {part}'
        if shape < 0.34:  # copula: S ist ADJ
            cop = ('waren' if past else 'sind') if plural else \
                  ('war' if past else 'ist')
            adj = r.choice(ADJECTIVES)
            extra = ' ' + self.pp() if r.random() < 0.3 else ''
            return f'{subj} {cop} {adj}{extra}'
        v, _, _, _, trans = self.verb_forms(plural, past)
        parts = [subj, v]
        if trans:
            parts.append(self.np('acc')[0])
        if r.random() < 0.45:
            parts.append(self.pp())
        if r.random() < 0.25:  # V2 inversion with fronted adverb
            adv = r.choice(ADVERBS)
            return adv + ' ' + parts[1] + ' ' + parts[0] + ' ' \
                + ' '.join(parts[2:])
        if r.random() < 0.3:
            parts.insert(2, r.choice(ADVERBS))
        return ' '.join(parts)

    def clause_sub(self, past: bool) -> str:
        """A verb-final subordinate clause (without the conjunction)."""
        r = self.r
        subj, plural = self.subject()
        v, inf, part, aux, trans = self.verb_forms(plural, past)
        mid: List[str] = []
        if trans:
            mid.append(self.np('acc')[0])
        if r.random() < 0.4:
            mid.append(self.pp())
        if r.random() < 0.2:  # perfect in sub clause: ... O PART hat
            av = ('haben' if plural else 'hat') if aux == 'haben' else \
                 ('sind' if plural else 'ist')
            return ' '.join([subj] + mid + [part, av])
        return ' '.join([subj] + mid + [v])

    def sentence(self) -> str:
        r = self.r
        past = r.random() < 0.45
        s = self.clause_main(past)
        x = r.random()
        if x < 0.18:
            s += ', ' + r.choice(SUBORD) + ' ' + self.clause_sub(past)
        elif x < 0.30:
            s += ', ' + r.choice(COORD) + ' ' + self.clause_main(past)
        elif x < 0.36:
            # relative clause appended to the whole statement
            g = r.choice('mfn')
            rel = {'m': 'der', 'f': 'die', 'n': 'das'}[g]
            s += ', ' + rel + ' ' + self.clause_sub(past)
        elif x < 0.40:
            year = 1750 + r.randrange(120)
            s = f'Im Jahre {year} ' + s[0].lower() + s[1:] if r.random() < 0.5 \
                else s + f' im Jahre {year}'
        elif x < 0.44:
            s = 'In ' + r.choice(CITIES) + ' ' + s[0].lower() + s[1:]
        # capitalize first letter, keep noun capitalization intact;
        # collapse double spaces left by empty optional slots
        s = ' '.join(s.split())
        s = s[0].upper() + s[1:]
        if r.random() < 0.05:
            return s + '?'
        if r.random() < 0.04:
            name = r.choice(NAMES)
            return '»' + s + '«, ' + r.choice(['sagte', 'rief', 'dachte',
                                               'schrieb']) + ' ' + name + '.'
        return s + '.'

    def paragraph(self) -> str:
        n = 3 + self.r.randrange(7)
        return ' '.join(self.sentence() for _ in range(n))


def generate(n_chars: int, seed: int = 0) -> str:
    """Generate ~n_chars of NFC-normalized German prose (paragraphs
    separated by blank lines, lines wrapped naturally by sentences)."""
    rng = random.Random(seed)
    g = _Gen(rng)
    out: List[str] = []
    total = 0
    while total < n_chars:
        p = g.paragraph()
        out.append(p)
        total += len(p) + 2
    return unicodedata.normalize('NFC', '\n\n'.join(out) + '\n')


# file naming follows the reference's training corpus convention
# author_title_year.txt (year drives the decade context variable,
# reference lib/rating.py:993-999)
#
# Each decade appears in >= 3 files: the stateful trainer splits
# validation off FILE-wise (reference rating.py:317-330), and a decade
# seen only in validation would leave its context embedding untrained
# (val loss then *rises* as the rest of the model co-adapts — observed).
DEFAULT_FILES = [
    ('weber_erzaehlungen_1781', 11),
    ('arnold_landleben_1784', 13),
    ('brandt_wanderungen_1788', 17),
    ('becker_naturlehre_1794', 23),
    ('seidel_betrachtungen_1792', 29),
    ('hoffmann_stadtleben_1797', 31),
    ('vogel_reisebilder_1806', 37),
    ('lang_jahreszeiten_1803', 41),
    ('winter_erinnerungen_1808', 43),
    ('krause_briefe_1813', 51),
    ('albrecht_gespraeche_1811', 53),
    ('fischer_chronik_1816', 59),
]


def write_corpus(outdir: str, n_chars: int = 3_000_000, seed: int = 0) -> List[str]:
    """Write a multi-file corpus totalling ~n_chars; returns file paths."""
    import os
    os.makedirs(outdir, exist_ok=True)
    per = n_chars // len(DEFAULT_FILES)
    paths = []
    for name, salt in DEFAULT_FILES:
        path = os.path.join(outdir, name + '.txt')
        with open(path, 'w', encoding='utf-8') as f:
            f.write(generate(per, seed=seed * 1000 + salt))
        paths.append(path)
    return paths


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--chars', type=int, default=3_000_000)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--out', required=True)
    args = ap.parse_args(argv)
    for p in write_corpus(args.out, args.chars, args.seed):
        print(p)


if __name__ == '__main__':
    main()
